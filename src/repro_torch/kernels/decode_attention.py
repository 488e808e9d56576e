"""Decode attention's CUDA kernel: binding and wrapper.

``decode_attention(q, k, v, pos)`` replaces
``repro/kernels/decode_attention.py::decode_attention``, the Pallas TPU
kernel, and computes the model's decode attention
(``repro/models/attention.py::decode_attention``): one query row per
(slot, head) against the slot's compact GQA ring cache, reading only the
rows that ``pos`` marks valid. Its source is
``csrc/decode_attention.cu``; the note there gives its design and its
bound.

A tensor on the CPU goes to the plain version in ``kernels/ref.py``. A
tensor on the card launches the kernel or raises: there is no fallback.
A tensor on ``meta`` (the dry run) is checked as the card's would be and
gets an empty result of the right shape; nothing is launched. ``cost``
gives the kernel's operations and bytes from its shapes, which the
wrapper reports to the op count (``kernels/count.py``) when one is
active, on every device.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, count, ref

SIGNATURES = {
    "decode_attention_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 +
    [ctypes.c_float, ctypes.c_void_p],
}
HEAD_DIMS = (16, 32, 64, 80, 128, 256)   # the head dims the kernel compiles
TILE_ROWS = 64               # a split is a whole number of bf16 tiles


def split_rows(S: int, D: int, group: int, dtype: torch.dtype) -> int:
    """Cache rows of one block of the kernel's first pass: a multiple of
    64, chosen from the ring's length, the head dim, the query heads per
    kv head and the type alone. It never sees the batch or the
    positions, so a slot's result (its splits, and the order in which
    they merge) does not depend on which other slots are busy.

    Tuned on the H100 at the served ticks (8 slots over 4096 rows, about
    half of them valid; ``benchmarks/torch_kernel_variant.py --splits``):
    in bf16 the groups of 3-5 heads read fastest in 512-row splits,
    granite-20b's 48 heads on one kv head (only 8 (slot, kv head) pairs,
    and a 24 KB partial state a split) in 128-row ones; float32, on the
    CUDA cores, in 128-row splits at D 64 and 80 and at 48 heads, 256
    at llama4-maverick-400b-a17b's 5 heads of 128."""
    if group >= 16:
        rows = 128
    elif dtype == torch.float32:
        rows = 128 if D <= 80 else 256
    else:
        rows = 512
    return max(TILE_ROWS, min(rows, -(-S // TILE_ROWS) * TILE_ROWS))


def scratch_floats(B: int, H: int, S: int, D: int, split: int) -> int:
    """Float32 scratch of one call: a partial state (D accumulators, the
    max and the sum) for every (slot, head, split) the ring can hold."""
    return B * H * -(-S // split) * (D + 2)


def kernel_takes(n_heads: int, n_kv: int, head_dim: int) -> bool:
    """Does the kernel compile this head shape? Any number of query heads
    per kv head (a block takes up to 64 of them, a larger group runs in
    chunks of 64) and a head dim of ``HEAD_DIMS``."""
    return n_kv > 0 and n_heads % n_kv == 0 and head_dim in HEAD_DIMS


def cost(q_shape, k_shape, dtype: torch.dtype, *, pos: bool = True,
         n_valid: Optional[int] = None):
    """(operations, bytes) of one launch: 4·D operations a valid cache
    row of each query head (Q.K^T and P.V); the valid rows of k and v
    read once, q read and the output written once, and the int32
    positions read (``pos``). ``n_valid``: the valid rows summed over the
    slots, which follow from the positions' values; None counts every
    ring row valid (a full cache), which is what the wrapper reports,
    since it never reads the positions on the host."""
    B, H, D = q_shape
    S, KV = k_shape[1], k_shape[2]
    rows = B * S if n_valid is None else int(n_valid)
    nbytes = (2 * rows * KV * D + 2 * B * H * D) * dtype.itemsize
    return 4 * D * H * rows, nbytes + (4 * B if pos else 0)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, H, D); k, v (B, S, KV, D) ring caches; pos (B,) absolute
    positions (ring row r is valid iff r <= pos or pos >= S) or None
    (every row valid) -> (B, H, D) in q's type. On the card ``pos`` is
    int32. ``decode_attention.launches`` counts the kernel's launches."""
    code = build.dtype_code(q, k, v)
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"decode attention takes q (B,H,D), k = v "
                         f"(B,S,KV,D); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KV == 0 or H % KV or S == 0:
        raise ValueError(f"cache {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    if pos is not None and tuple(pos.shape) != (B,):
        raise ValueError(f"pos has shape {tuple(pos.shape)}, not ({B},)")
    for t in (k, v) + (() if pos is None else (pos,)):
        if t.device != q.device:
            raise ValueError(f"a tensor is on {t.device}, q on {q.device}")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"decode attention runs on cpu, cuda or meta, not "
                         f"{q.device}")
    with (count.kernel("decode_attention", cost(
            q.shape, k.shape, q.dtype, pos=pos is not None), q.dtype)
          if count.ACTIVE else count.NOT_COUNTING):
        if q.device.type == "cpu":
            return ref.decode_attention(q, k, v, pos)
        _check_kernel(q, k, v, pos)
        if q.device.type == "meta":
            return build.empty_like(q)
        return _launch(q, k, v, pos, code)


def _check_kernel(q, k, v, pos) -> None:
    """What the kernel takes beyond the plain version (the card's and
    the dry run's shapes)."""
    H, D, KV = q.shape[1], q.shape[2], k.shape[2]
    if not kernel_takes(H, KV, D):
        raise ValueError(f"head dim {D} is not one the kernel compiles "
                         f"{HEAD_DIMS}")
    if pos is not None and pos.dtype != torch.int32:
        raise TypeError(f"pos is int32 on the card, not {pos.dtype}")
    build.check_launchable(q, k, v, *(() if pos is None else (pos,)))


def _launch(q, k, v, pos, code) -> torch.Tensor:
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    lib = build.load("decode_attention", SIGNATURES)
    split = split_rows(S, D, H // KV, q.dtype)
    part = torch.empty(scratch_floats(B, H, S, D, split),
                       dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    build.launch(lib.decode_attention_fwd, q.device, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(),
                 None if pos is None else pos.data_ptr(), out.data_ptr(),
                 part.data_ptr(), code, B, H, KV, S, D, split,
                 1.0 / D ** 0.5,
                 what=f"decode_attention at q {tuple(q.shape)}, "
                      f"cache {tuple(k.shape)}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
