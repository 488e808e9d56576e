"""The grouped expert matmul's CUDA kernel: binding and wrapper.

``moe_gmm(x, w)`` replaces ``repro/kernels/moe_gmm.py::moe_gmm``, the
Pallas TPU kernel: ``x[e] @ w[e]`` for every expert e, x (E, C, d) and
w (E, d, f) -> (E, C, f), summed in float32 and rounded once to x's
type. Its source is ``csrc/moe_gmm.cu``; the note there gives its design
and its bound. In bfloat16 it runs on Hopper's tensor cores (``wgmma``,
float32 accumulators) with its tiles brought by TMA, so it needs an
``sm_90a`` card; in float32 it runs on the CUDA cores, since the tensor
cores would round float32 operands to TF32.

Under autograd (a grad-enabled call where x or w requires grad) the call
goes through ``MoeGmmFn``, whose backward ``moe_gmm_bwd`` computes ``dx
= dy w^T`` and ``dw = x^T dy`` in two launches of the same kernel with
other operand majors (``moe_gmm_bwd`` in the source), reading x, w and
dy in place: w as a K-major B operand for dx, x as an MN-major A operand
for dw, whose contracted capacity C may be any size (its edge arrives as
zeros), so no copy, transpose or padding is made, in either type. dw
comes out in x's type, as the JAX graph's bf16 product does before its
cast to the float32 master weight. On the CPU the backward is the plain
``ref.moe_gmm_bwd``.

A tensor on the CPU goes to the plain version in ``kernels/ref.py``. A
tensor on the card launches the kernel or raises: there is no fallback.
A tensor on ``meta`` (the dry run) is checked as the card's would be and
gets empty results of the right shapes; nothing is launched. ``cost``
and ``bwd_cost`` give the kernels' operations and bytes from their
shapes, which the wrapper reports to the op count
(``kernels/count.py``) when one is active, on every device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, count, ref

SIGNATURES = {"moe_gmm_fwd": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 +
              [ctypes.c_void_p],
              "moe_gmm_bwd": [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 +
              [ctypes.c_void_p]}


def cost(x_shape, f: int, dtype: torch.dtype):
    """(operations, bytes) of one forward launch, x (E, C, d) times w (E,
    d, f): 2 operations a multiply-add; x and w read and the output
    written once."""
    E, C, d = x_shape
    return 2 * E * C * d * f, (E * C * d + E * d * f + E * C * f) * \
        dtype.itemsize


def bwd_cost(x_shape, f: int, dtype: torch.dtype):
    """(operations, bytes) of one backward call (its two launches, dx and
    dw): twice the forward's operations; x, w and dy read once and dx
    and dw written once."""
    E, C, d = x_shape
    return 4 * E * C * d * f, (2 * E * C * d + 2 * E * d * f + E * C * f) \
        * dtype.itemsize


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (E, C, d), w (E, d, f), both float32 or both bfloat16 -> (E, C,
    f) in x's type. C may be any size; on the card d and f are multiples
    of 8 (the rows of x and w are then whole 16-byte units, as TMA needs
    them). A row's result depends on neither C nor the other rows.
    ``moe_gmm.launches`` counts the kernel's launches. Differentiable
    (``MoeGmmFn``)."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return MoeGmmFn.apply(x, w)
    out = _product(x, w)
    if x.device.type == "cuda":
        moe_gmm.launches += 1
    return out


def _check(x: torch.Tensor, w: torch.Tensor) -> int:
    """What both kernels take: x (E, C, d) and w (E, d, f) on one device,
    both float32 or both bfloat16, d and f multiples of 8 on the card.
    Returns the kernels' type code."""
    code = build.dtype_code(x, w)
    if x.dim() != 3 or w.dim() != 3 or w.shape[0] != x.shape[0] \
            or w.shape[1] != x.shape[2]:
        raise ValueError(f"moe_gmm takes x (E, C, d) and w (E, d, f); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if w.device != x.device:
        raise ValueError(f"w is on {w.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"moe_gmm runs on cpu, cuda or meta, not "
                         f"{x.device}")
    d, f = w.shape[1], w.shape[2]
    if x.device.type != "cpu" and (d % 8 or f % 8):
        raise ValueError(f"the kernel takes d and f in multiples of 8 "
                         f"(16-byte rows for TMA); got d {d}, f {f}")
    return code


def _product(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x[e] @ w[e]: the plain version on the CPU, one launch on the card."""
    code = _check(x, w)
    with (count.kernel("moe_gmm", cost(x.shape, w.shape[2], x.dtype),
                       x.dtype) if count.ACTIVE else count.NOT_COUNTING):
        if x.device.type == "cpu":
            return ref.moe_gmm(x, w)
        build.check_launchable(x, w)
        if x.device.type == "meta":
            return x.new_empty((x.shape[0], x.shape[1], w.shape[2]))
        return _launch(x, w, code)


def _launch(x: torch.Tensor, w: torch.Tensor, code: int) -> torch.Tensor:
    E, C, d = x.shape
    f = w.shape[2]
    out = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    build.launch(build.load("moe_gmm", SIGNATURES).moe_gmm_fwd, x.device,
                 x.data_ptr(), w.data_ptr(), out.data_ptr(), code, E, C, d,
                 f, what=f"moe_gmm at x {tuple(x.shape)}, w {tuple(w.shape)}")
    return out


def moe_gmm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor):
    """(dx in x's type, dw in w's type) of ``moe_gmm`` for the output
    gradient dy (E, C, f): on the card two launches, counted by
    ``moe_gmm_bwd.launches``, with no copy of x, w or dy."""
    code = _check(x, w)
    E, C, d = x.shape
    f = w.shape[2]
    if dy.shape != (E, C, f) or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} does not fit x "
                         f"{tuple(x.shape)} and w {tuple(w.shape)}")
    with (count.kernel("moe_gmm_bwd", bwd_cost(x.shape, f, x.dtype),
                       x.dtype) if count.ACTIVE else count.NOT_COUNTING):
        if x.device.type == "cpu":
            return ref.moe_gmm_bwd(x, w, dy)
        if x.device.type == "meta":
            return build.empty_like(x), build.empty_like(w)
        return _launch_bwd(x, w, dy, code)


def _launch_bwd(x, w, dy, code):
    E, C, d = x.shape
    f = w.shape[2]
    dy = dy.contiguous()
    build.check_launchable(x, w, dy)
    dx = torch.empty_like(x)
    dw = torch.zeros_like(w) if C == 0 else torch.empty_like(w)
    build.launch(build.load("moe_gmm", SIGNATURES).moe_gmm_bwd, x.device,
                 x.data_ptr(), w.data_ptr(), dy.data_ptr(), dx.data_ptr(),
                 dw.data_ptr(), code, E, C, d, f,
                 what=f"moe_gmm_bwd at x {tuple(x.shape)}, w {tuple(w.shape)}")
    moe_gmm_bwd.launches += 2
    return dx, dw


class MoeGmmFn(torch.autograd.Function):
    """The grouped expert matmul under autograd: the kernel forward, then
    ``moe_gmm_bwd`` (x and w saved)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        out = _product(x, w)
        if x.device.type == "cuda":
            moe_gmm.launches += 1
        return out

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return moe_gmm_bwd(x, w, dy)


moe_gmm.launches = 0
moe_gmm_bwd.launches = 0
