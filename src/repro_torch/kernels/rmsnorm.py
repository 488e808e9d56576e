"""RMSNorm's CUDA kernel: binding and wrapper.

``rmsnorm(x, scale, eps)`` replaces ``repro/kernels/rmsnorm.py::rmsnorm``,
the Pallas TPU kernel: ``x * rsqrt(mean(x^2) + eps) * scale`` per row,
float32 inside, rounded back to x's type. Its source is
``csrc/rmsnorm.cu``; the note there gives its design and its bound.

Under autograd (a grad-enabled call whose x or scale requires grad) the
call goes through ``RMSNormFn``, whose backward is ``rmsnorm_bwd``: the
hand-written backward kernel in the same source (dx, and dscale from
per-block partial rows added in a fixed order), or on the CPU its plain
version ``ref.rmsnorm_bwd``. The JAX package has no backward kernel; it
trains through XLA's derivative of the plain norm.

A tensor on the CPU goes to the plain version in ``kernels/ref.py``. A
tensor on the card launches the kernel or raises: there is no fallback.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref

MAX_D = 8192          # a row's values: 256 threads x 32 values
PARTIALS = 264        # the backward's blocks at most (csrc kPartials)
SIGNATURES = {"rmsnorm_fwd": [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
    ctypes.c_void_p],
    "rmsnorm_bwd": [ctypes.c_void_p] * 6 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
    ctypes.c_void_p]}


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x (..., D) float32 or bfloat16; scale (D,) float32 -> x's shape
    and type. On the card a row's result depends only on the row and D,
    not on the row count. ``rmsnorm.launches`` counts the kernel's
    launches. Differentiable (``RMSNormFn``)."""
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return RMSNormFn.apply(x, scale, eps)
    return _forward(x, scale, eps)


def _check(x: torch.Tensor, scale: torch.Tensor) -> int:
    code = build.dtype_code(x)
    if scale.dtype != torch.float32:
        raise TypeError(f"rmsnorm's scale is float32, not {scale.dtype}")
    if x.dim() < 1 or tuple(scale.shape) != (x.shape[-1],):
        raise ValueError(f"rmsnorm takes x (..., D) and scale (D,); got "
                         f"{tuple(x.shape)} and {tuple(scale.shape)}")
    if scale.device != x.device:
        raise ValueError(f"scale is on {scale.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"rmsnorm runs on cpu or cuda, not {x.device}")
    if x.device.type == "cuda":
        if not (x.is_contiguous() and scale.is_contiguous()):
            raise ValueError("rmsnorm takes contiguous tensors")
        if x.shape[-1] > MAX_D:
            raise ValueError(f"the kernel takes rows of at most {MAX_D} "
                             f"values; got {x.shape[-1]}")
    return code


def _forward(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    code = _check(x, scale)
    if x.device.type == "cpu":
        return ref.rmsnorm(x, scale, eps)
    d = x.shape[-1]
    out = torch.empty_like(x)
    rows = x.numel() // d if d else 0
    build.launch(build.load("rmsnorm", SIGNATURES).rmsnorm_fwd, x.device,
                 x.data_ptr(), scale.data_ptr(), out.data_ptr(), code, rows,
                 d, eps, what=f"rmsnorm at x {tuple(x.shape)}")
    rmsnorm.launches += 1
    return out


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-6):
    """The norm's gradients: (dx in x's type and shape, dscale (D,)
    float32) from x, scale and the output's gradient dy (x's type and
    shape). On the card the backward kernel; ``rmsnorm_bwd.launches``
    counts its launches."""
    code = _check(x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    if x.device.type == "cpu":
        return ref.rmsnorm_bwd(x, scale, dy, eps)
    dy = dy.contiguous()
    d = x.shape[-1]
    dx = torch.empty_like(x)
    dscale = torch.empty(d, dtype=torch.float32, device=x.device)
    partials = torch.empty((PARTIALS, d), dtype=torch.float32,
                           device=x.device)
    rows = x.numel() // d if d else 0
    build.launch(build.load("rmsnorm", SIGNATURES).rmsnorm_bwd, x.device,
                 x.data_ptr(), scale.data_ptr(), dy.data_ptr(),
                 dx.data_ptr(), partials.data_ptr(), dscale.data_ptr(), code,
                 rows, d, eps, what=f"rmsnorm_bwd at x {tuple(x.shape)}")
    rmsnorm_bwd.launches += 1
    return dx, dscale


class RMSNormFn(torch.autograd.Function):
    """The norm under autograd: the forward kernel, then ``rmsnorm_bwd``
    (x and scale saved, the row's rstd recomputed)."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.eps = eps
        ctx.save_for_backward(x, scale)
        return _forward(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, dy, ctx.eps)
        return dx, dscale, None


rmsnorm.launches = 0
rmsnorm_bwd.launches = 0
