"""RMSNorm's CUDA kernel: binding and wrapper.

``rmsnorm(x, scale, eps)`` replaces ``repro/kernels/rmsnorm.py::rmsnorm``,
the Pallas TPU kernel: ``x * rsqrt(mean(x^2) + eps) * scale`` per row,
float32 inside, rounded back to x's type. Its source is
``csrc/rmsnorm.cu``; the note there gives its design and its bound.

Under autograd (a grad-enabled call whose x or scale requires grad) the
call goes through ``RMSNormFn``, whose backward is ``rmsnorm_bwd``: the
hand-written backward kernel in the same source (one cooperative launch:
dx, and dscale from per-block partial rows added in a fixed order inside
the launch), or on the CPU its plain version ``ref.rmsnorm_bwd``. The
JAX package has no backward kernel; it trains through XLA's derivative
of the plain norm.

A tensor on the CPU goes to the plain version in ``kernels/ref.py``. A
tensor on the card launches the kernel or raises: there is no fallback.
A tensor on ``meta`` (the dry run, ``launch/dryrun.py``) is checked as
the card's would be and gets an empty result of the right shape; nothing
is launched. ``cost`` and ``bwd_cost`` give each kernel's operations and
bytes from its shapes, which the wrapper reports to the op count
(``kernels/count.py``) when one is active, on every device.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, count, ref

MAX_D = 8192          # a row's values: 256 threads x 32 values
SIGNATURES = {"rmsnorm_fwd": [ctypes.c_void_p] * 3 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
    ctypes.c_void_p],
    "rmsnorm_bwd_partials": [ctypes.c_void_p] * 4 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int],
    "rmsnorm_bwd": [ctypes.c_void_p] * 6 + [
    ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
    ctypes.c_void_p]}


def cost(shape, dtype: torch.dtype):
    """(operations, bytes) of one forward launch over x of ``shape``:
    3 operations a value (its square, its share of the mean, the
    scaling); x read and y written once, the float32 scale read once."""
    n, d = math.prod(shape), shape[-1]
    return 3 * n, 2 * n * dtype.itemsize + 4 * d


def bwd_cost(shape, dtype: torch.dtype):
    """(operations, bytes) of one backward launch: 10 operations a
    value; x and dy read and dx written once, the scale read and dscale
    written once (the partial rows of dscale are the design's own
    traffic, not counted)."""
    n, d = math.prod(shape), shape[-1]
    return 10 * n, 3 * n * dtype.itemsize + 8 * d


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
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"rmsnorm runs on cpu, cuda or meta, not "
                         f"{x.device}")
    if x.device.type != "cpu":
        if not (x.is_contiguous() and scale.is_contiguous()):
            raise ValueError("rmsnorm takes contiguous tensors")
        if x.shape[-1] > MAX_D:
            raise ValueError(f"the kernel takes rows of at most {MAX_D} "
                             f"values; got {x.shape[-1]}")
    return code


def _forward(x: torch.Tensor, scale: torch.Tensor,
             eps: float) -> torch.Tensor:
    code = _check(x, scale)
    with (count.kernel("rmsnorm", cost(x.shape, x.dtype), x.dtype)
          if count.ACTIVE else count.NOT_COUNTING):
        if x.device.type == "cpu":
            return ref.rmsnorm(x, scale, eps)
        if x.device.type == "meta":
            return build.empty_like(x)
        return _launch(x, scale, eps, code)


def _launch(x, scale, eps, code) -> torch.Tensor:
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
    shape). On the card the backward kernel, one launch, with the partial
    rows its grid needs as scratch; the same inputs give the same bits,
    and a row's dx does not depend on the row count.
    ``rmsnorm_bwd.launches`` counts its launches."""
    code = _check(x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} does not match x "
                         f"{tuple(x.shape)} {x.dtype}")
    with (count.kernel("rmsnorm_bwd", bwd_cost(x.shape, x.dtype), x.dtype)
          if count.ACTIVE else count.NOT_COUNTING):
        if x.device.type == "cpu":
            return ref.rmsnorm_bwd(x, scale, dy, eps)
        if x.device.type == "meta":
            return build.empty_like(x), build.empty_like(scale)
        return _launch_bwd(x, scale, dy, eps, code)


def _launch_bwd(x, scale, dy, eps, code):
    dy = dy.contiguous()
    d = x.shape[-1]
    dx = torch.empty_like(x)
    dscale = torch.empty(d, dtype=torch.float32, device=x.device)
    rows = x.numel() // d if d else 0
    lib = build.load("rmsnorm", SIGNATURES)
    ptrs = (x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx.data_ptr())
    with torch.cuda.device(x.device):
        need = lib.rmsnorm_bwd_partials(*ptrs, code, rows, d)
    if need < 0:
        raise RuntimeError(f"rmsnorm_bwd at x {tuple(x.shape)}: no launch "
                           f"plan, CUDA error {-need}")
    partials = torch.empty((need, d), dtype=torch.float32, device=x.device)
    build.launch(lib.rmsnorm_bwd, x.device, *ptrs, partials.data_ptr(),
                 dscale.data_ptr(), code, rows, d, eps,
                 what=f"rmsnorm_bwd at x {tuple(x.shape)}")
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
