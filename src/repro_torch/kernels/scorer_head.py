"""The scorer's dense and head layers as one CUDA kernel: binding and
wrapper.

``scorer_head(h, wd, bd, wh, bh)`` computes ``relu(h @ wd + bd) @ wh +
bh`` in float32. It replaces no Pallas kernel: it stands for the JAX
package's two XLA matmuls in the scorer body (``repro/core/runtime.py``,
l.200-201), and exists for the port's invariant that every dispatch
layer scores a frame to the same bits. Each output is summed in one
fixed order that depends on neither the row count nor the row's place,
where a library matmul may change its algorithm with the row count. Its
source is ``csrc/scorer_head.cu``; the note there gives its design and
its bound. With a leading member axis on every argument it is the
grouped form that the stacked superbatch runs: one launch for every
member (the JAX package's two matmuls under ``jax.vmap``), each
member's output bit for bit the ungrouped launch's on its own inputs.

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

import torch

from repro_torch.kernels import build, count, ref

MAX_DENSE = 64                # dense units a row of the kernel holds
# the ungrouped C interface, which every design of the kernel has
SIGNATURES = {"scorer_head_f32": [ctypes.c_void_p] * 6 +
              [ctypes.c_int] * 3 + [ctypes.c_void_p]}
GROUPED_SIGNATURES = {"scorer_head_grouped_f32": [ctypes.c_void_p] * 6 +
                      [ctypes.c_int] * 4 + [ctypes.c_void_p]}


def cost(m: int, feat: int, dense: int, members: int = 1):
    """(operations, bytes) of one launch over ``members`` members of M
    rows: 2 operations a multiply-add of both layers; h, the weights and
    biases read once and the (M, 2) output written once, float32."""
    flops = 2 * m * dense * (feat + 2)
    nbytes = 4 * (m * feat + feat * dense + dense + 2 * dense + 2 + 2 * m)
    return members * flops, members * nbytes


def scorer_head(h: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor,
                wh: torch.Tensor, bh: torch.Tensor) -> torch.Tensor:
    """h (M, feat), wd (feat, dense), bd (dense,), wh (dense, 2), bh (2,),
    all float32 -> (M, 2); or, grouped, each with a leading member axis
    Q -> (Q, M, 2), member q with its own weights. A row's result
    depends neither on M, nor on Q, nor on the other rows.
    ``scorer_head.launches`` counts the kernel's launches (a grouped one
    once), ``scorer_head.grouped_launches`` the grouped ones."""
    tensors = {"h": h, "wd": wd, "bd": bd, "wh": wh, "bh": bh}
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"scorer_head takes float32; {name} is {t.dtype}")
        if t.device != h.device:
            raise ValueError(f"{name} is on {t.device}, h on {h.device}")
    grouped = h.dim() == 3
    lead = tuple(h.shape[:1]) if grouped else ()
    if h.dim() != 2 + len(lead) or wd.dim() != 2 + len(lead) or \
            tuple(wd.shape[:-1]) != tuple(h.shape[:-2]) + (h.shape[-1],) or \
            tuple(bd.shape) != lead + (wd.shape[-1],) or \
            tuple(wh.shape) != lead + (wd.shape[-1], 2) or \
            tuple(bh.shape) != lead + (2,):
        raise ValueError(
            "scorer_head takes h (M, feat), wd (feat, dense), bd (dense,), "
            "wh (dense, 2), bh (2,), or each with a leading member axis; "
            f"got {[tuple(t.shape) for t in tensors.values()]}")
    if h.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"scorer_head runs on cpu, cuda or meta, not "
                         f"{h.device}")
    q = h.shape[0] if grouped else 1
    M, feat = h.shape[-2:]
    dense = wd.shape[-1]
    with (count.kernel("scorer_head", cost(M, feat, dense, q), h.dtype)
          if count.ACTIVE else count.NOT_COUNTING):
        if h.device.type == "cpu":
            return (ref.scorer_head_grouped if grouped else
                    ref.scorer_head)(h, wd, bd, wh, bh)
        if dense > MAX_DENSE:
            raise ValueError(f"the kernel takes at most {MAX_DENSE} dense "
                             f"units; got {dense}")
        build.check_launchable(*tensors.values())
        if h.device.type == "meta":
            return h.new_empty(lead + (M, 2))
        return _launch(h, wd, bd, wh, bh)


def _launch(h, wd, bd, wh, bh) -> torch.Tensor:
    grouped = h.dim() == 3
    lead = tuple(h.shape[:1]) if grouped else ()
    q = h.shape[0] if grouped else 1
    M, feat = h.shape[-2:]
    dense = wd.shape[-1]
    out = torch.empty(lead + (M, 2), dtype=torch.float32, device=h.device)
    build.launch(build.load("scorer_head", SIGNATURES | GROUPED_SIGNATURES)
                 .scorer_head_grouped_f32,
                 h.device, h.data_ptr(), wd.data_ptr(), bd.data_ptr(),
                 wh.data_ptr(), bh.data_ptr(), out.data_ptr(), q, M, feat,
                 dense, what=f"scorer_head at h {tuple(h.shape)}, "
                             f"wd {tuple(wd.shape)}")
    scorer_head.launches += 1
    if grouped:
        scorer_head.grouped_launches += 1
    return out


scorer_head.launches = 0
scorer_head.grouped_launches = 0
