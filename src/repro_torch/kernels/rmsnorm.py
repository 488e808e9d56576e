"""RMSNorm's CUDA kernel: binding and wrapper.

``rmsnorm(x, scale, eps)`` replaces ``repro/kernels/rmsnorm.py::rmsnorm``,
the Pallas TPU kernel: ``x * rsqrt(mean(x^2) + eps) * scale`` per row,
float32 inside, rounded back to x's type. Its source is
``csrc/rmsnorm.cu``; the note there gives its design and its bound.

A tensor on the CPU goes to the plain version in ``kernels/ref.py``. A
tensor on the card launches the kernel or raises: there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

MAX_D = 8192          # a row's values: 256 threads x 32 values
SIGNATURES = {"rmsnorm_fwd": [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
    ctypes.c_void_p]}


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x (..., D) float32 or bfloat16; scale (D,) float32 -> x's shape
    and type. On the card a row's result depends only on the row and D,
    not on the row count. ``rmsnorm.launches`` counts the kernel's
    launches."""
    code = build.dtype_code(x)
    if scale.dtype != torch.float32:
        raise TypeError(f"rmsnorm's scale is float32, not {scale.dtype}")
    if x.dim() < 1 or tuple(scale.shape) != (x.shape[-1],):
        raise ValueError(f"rmsnorm takes x (..., D) and scale (D,); got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if scale.device != x.device:
        raise ValueError(f"scale is on {scale.device}, x on {x.device}")
    if x.device.type == "cpu":
        return ref.rmsnorm(x, scale, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on cpu or cuda, not {x.device}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm takes contiguous tensors")
    d = x.shape[-1]
    if d > MAX_D:
        raise ValueError(f"the kernel takes rows of at most {MAX_D} "
                         f"values; got {d}")
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    build.launch(build.load("rmsnorm", SIGNATURES).rmsnorm_fwd, x.device,
                 x.data_ptr(), scale.data_ptr(), out.data_ptr(), code, rows,
                 d, eps, what=f"rmsnorm at x {tuple(x.shape)}")
    rmsnorm.launches += 1
    return out


rmsnorm.launches = 0
