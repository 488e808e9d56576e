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
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, ref

SIGNATURES = {
    "decode_attention_fwd": [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 +
    [ctypes.c_float, ctypes.c_void_p],
    "decode_attention_split_rows": [],
}


def kernel_takes(n_heads: int, n_kv: int, head_dim: int) -> bool:
    """Does the kernel compile this head shape? Any number of query heads
    per kv head (a block takes a group of up to 7 as it is, a larger one
    in chunks of 8), and a head dim that is a multiple of 8 up to 256."""
    return (n_kv > 0 and n_heads % n_kv == 0 and head_dim % 8 == 0
            and 0 < head_dim <= 256)


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
    if q.device.type == "cpu":
        return ref.decode_attention(q, k, v, pos)
    if q.device.type != "cuda":
        raise ValueError(f"decode attention runs on cpu or cuda, not "
                         f"{q.device}")
    if not kernel_takes(H, KV, D):
        raise ValueError(f"head dim {D} is not one the kernel compiles "
                         "(a multiple of 8 up to 256)")
    if pos is not None and pos.dtype != torch.int32:
        raise TypeError(f"pos is int32 on the card, not {pos.dtype}")
    build.check_launchable(q, k, v, *(() if pos is None else (pos,)))
    lib = build.load("decode_attention", SIGNATURES)
    splits = -(-S // lib.decode_attention_split_rows())
    part = torch.empty(B * H * splits * (D + 2), dtype=torch.float32,
                       device=q.device)
    out = torch.empty_like(q)
    build.launch(lib.decode_attention_fwd, q.device, q.data_ptr(),
                 k.data_ptr(), v.data_ptr(),
                 None if pos is None else pos.data_ptr(), out.data_ptr(),
                 part.data_ptr(), code, B, H, KV, S, D, 1.0 / D ** 0.5,
                 what=f"decode_attention at q {tuple(q.shape)}, "
                      f"cache {tuple(k.shape)}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
