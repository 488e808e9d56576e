"""The conv scorer's CUDA kernel: build, binding and wrapper.

``conv_scorer(x, w, b)`` replaces ``repro/kernels/conv_scorer.py::
conv_scorer``, the Pallas TPU kernel: a fused 3x3 SAME conv + bias +
ReLU over NHWC float32. Its source is ``csrc/conv_scorer.cu``; the note
there gives its design and its bound on the card. With a leading member
axis on x, w and b it is the grouped form, the counterpart of
``jax.vmap`` of the Pallas kernel that the JAX package's stacked
superbatch runs: one launch for every member, each member's output bit
for bit the ungrouped launch's on its own inputs.

A tensor on the CPU goes to the plain version in ``kernels/ref.py``. A
tensor on the card launches the kernel or raises: there is no fallback.
The kernel is built at first use by ``kernels/build.py``, with ``nvcc``
for ``sm_90a``, and rebuilt when the source changes. Nothing
CUDA-specific happens at import time. A tensor on ``meta`` (the dry
run) is checked as the card's would be and gets an empty result of the
right shape; nothing is launched. ``cost`` gives the kernel's operations
and bytes from its shapes, which the wrapper reports to the op count
(``kernels/count.py``) when one is active, on every device.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, count, ref

COUTS = (8, 16, 24, 32)       # output channels the kernel compiles
MAX_SMEM_BYTES = 232_448      # shared memory a block may use on Hopper

# the ungrouped C interface, which every design of the kernel has
SIGNATURES = {"conv_scorer_f32": [ctypes.c_void_p] * 4 +
              [ctypes.c_int] * 10 + [ctypes.c_void_p]}
GROUPED_SIGNATURES = {"conv_scorer_grouped_f32": [ctypes.c_void_p] * 4 +
                      [ctypes.c_int] * 11 + [ctypes.c_void_p]}


def valid_taps(h: int, stride: int = 2) -> int:
    """Kernel taps along one axis that land inside the image, summed over
    the outputs: the taps on SAME padding multiply zeros and are
    skipped."""
    ho, top, _ = ref.same_pad(h, stride)
    return sum(0 <= o * stride - top + k < h
               for o in range(ho) for k in range(3))


def cost(x_shape, cout: int, stride: int = 2):
    """(operations, bytes) of one launch over x (N, H, W, Cin), or a
    grouped x (Q, N, H, W, Cin): 2·Cin operations a tap that lands
    inside the image of each output (``valid_taps``), bias and ReLU not
    counted; x, w and b read once and the output written once, float32."""
    q = x_shape[0] if len(x_shape) == 5 else 1
    n, h, wd, cin = x_shape[-4:]
    ho, wo = ref.same_pad(h, stride)[0], ref.same_pad(wd, stride)[0]
    flops = 2 * cin * cout * n * valid_taps(h, stride) * \
        valid_taps(wd, stride)
    nbytes = 4 * (n * h * wd * cin + 9 * cin * cout + cout +
                  n * ho * wo * cout)
    return q * flops, q * nbytes


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           stride: int) -> None:
    grouped = x.dim() == 5
    lead = 1 if grouped else 0
    if x.dim() != 4 + lead or w.dim() != 4 + lead or b.dim() != 1 + lead:
        raise ValueError("conv_scorer takes x (N,H,W,Cin), w (3,3,Cin,Cout), "
                         "b (Cout,), or each with a leading member axis; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    if grouped and not x.shape[0] == w.shape[0] == b.shape[0]:
        raise ValueError(f"member counts differ: x {tuple(x.shape)}, "
                         f"w {tuple(w.shape)}, b {tuple(b.shape)}")
    cin, cout = x.shape[-1], w.shape[-1]
    if tuple(w.shape[lead:lead + 3]) != (3, 3, cin) or b.shape[-1] != cout:
        raise ValueError(f"weights {tuple(w.shape)} / bias {tuple(b.shape)} "
                         f"do not fit {cin} input channels")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"conv_scorer takes float32; {name} is {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _pixel_floats(cin: int) -> int:
    """Floats a pixel takes in the kernel's shared memory: the least
    count >= Cin that is 4 modulo 8 (``csrc/conv_scorer.cu``)."""
    s = -(-cin // 4) * 4
    return s + 4 if s % 8 == 0 else s


def _check_kernel(w: torch.Tensor, width: int, stride: int) -> None:
    """What the CUDA kernel takes beyond the plain version: Cout in
    ``COUTS``, and one output row's strip (3 input rows), the weights
    and the bias within a block's shared memory."""
    cin, cout = w.shape[-2], w.shape[-1]
    if cout not in COUTS:
        raise ValueError(f"the kernel compiles Cout {COUTS}, not {cout}")
    s = _pixel_floats(cin)
    row = stride * -(-width // stride) * s
    if 4 * (9 * cin * cout + cout + s + 3 * row) > MAX_SMEM_BYTES:
        raise ValueError(f"a {width}-wide row of {cin} channels and "
                         f"{cin}x{cout} weights exceed the kernel's shared "
                         "memory")


def conv_scorer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                stride: int = 2) -> torch.Tensor:
    """Fused 3x3 SAME conv + bias + ReLU. x: (N, H, W, Cin) float32
    NHWC, w: (3, 3, Cin, Cout) HWIO -> (N, Ho, Wo, Cout); or, grouped,
    x (Q, N, H, W, Cin), w (Q, 3, 3, Cin, Cout), b (Q, Cout) -> (Q, N,
    Ho, Wo, Cout), member q convolved with its own weights.

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``conv_scorer.launches`` counts each launch, a grouped one once, and
    ``conv_scorer.grouped_launches`` the grouped ones) or raise."""
    _check(x, w, b, stride)
    if x.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"conv_scorer runs on cpu, cuda or meta, not "
                         f"{x.device}")
    grouped = x.dim() == 5
    with (count.kernel("conv_scorer", cost(x.shape, w.shape[-1], stride),
                       x.dtype) if count.ACTIVE else count.NOT_COUNTING):
        if x.device.type == "cpu":
            return (ref.conv_scorer_grouped if grouped else
                    ref.conv_scorer)(x, w, b, stride)
        build.check_launchable(x, w, b)
        _check_kernel(w, x.shape[-2], stride)
        if x.device.type == "meta":
            return x.new_empty(x.shape[:-3] + (
                ref.same_pad(x.shape[-3], stride)[0],
                ref.same_pad(x.shape[-2], stride)[0], w.shape[-1]))
        return _launch(x, w, b, stride)


def _launch(x, w, b, stride) -> torch.Tensor:
    grouped = x.dim() == 5
    q = x.shape[0] if grouped else 1
    n, h, wd, cin = x.shape[-4:]
    cout = w.shape[-1]
    ho, top, _ = ref.same_pad(h, stride)
    wo, left, _ = ref.same_pad(wd, stride)
    out = torch.empty(x.shape[:-3] + (ho, wo, cout), device=x.device,
                      dtype=torch.float32)
    if out.numel() == 0:
        return out
    build.launch(build.load("conv_scorer", SIGNATURES | GROUPED_SIGNATURES)
                 .conv_scorer_grouped_f32,
                 x.device, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                 out.data_ptr(), q, n, h, wd, cin, cout, ho, wo, stride, top,
                 left, what=f"conv_scorer at x {tuple(x.shape)}, "
                            f"w {tuple(w.shape)}")
    conv_scorer.launches += 1
    if grouped:
        conv_scorer.grouped_launches += 1
    return out


conv_scorer.launches = 0
conv_scorer.grouped_launches = 0
