"""The grouped expert matmul's CUDA kernel: binding and wrapper.

``moe_gmm(x, w)`` replaces ``repro/kernels/moe_gmm.py::moe_gmm``, the
Pallas TPU kernel: ``x[e] @ w[e]`` for every expert e, x (E, C, d) and
w (E, d, f) -> (E, C, f), summed in float32 and rounded once to x's
type. Its source is ``csrc/moe_gmm.cu``; the note there gives its design
and its bound.

A tensor on the CPU goes to the plain version in ``kernels/ref.py``. A
tensor on the card launches the kernel or raises: there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

SIGNATURES = {"moe_gmm_fwd": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 +
              [ctypes.c_void_p]}


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, C, d), w (E, d, f), both float32 or both bfloat16 -> (E, C,
    f) in x's type. C may be any size; on the card d and f are multiples
    of 8. ``moe_gmm.launches`` counts the kernel's launches."""
    code = build.dtype_code(x, w)
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"moe_gmm takes x (E, C, d) and w (E, d, f); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if x.device.type == "cpu":
        return ref.moe_gmm(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm runs on cpu or cuda, not {x.device}")
    E, C, d = x.shape
    f = w.shape[2]
    if d % 8 or f % 8:
        raise ValueError(f"the kernel takes d and f in multiples of 8; got "
                         f"d {d}, f {f}")
    build.check_launchable(x, w)
    out = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    build.launch(build.load("moe_gmm", SIGNATURES).moe_gmm_fwd, x.device,
                 x.data_ptr(), w.data_ptr(), out.data_ptr(), code, E, C, d,
                 f, what=f"moe_gmm at x {tuple(x.shape)}, w {tuple(w.shape)}")
    moe_gmm.launches += 1
    return out


moe_gmm.launches = 0
