"""Plain PyTorch versions of the hand-written kernels (the references).

Each function is the mathematical definition with no tiling or fusion:
the CPU tests run it against the JAX package's references, and
``chip_smoke.py`` holds each kernel against it on the card.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def same_pad(size: int, stride: int, k: int = 3) -> Tuple[int, int, int]:
    """``(out, before, after)`` of XLA's SAME padding along one axis.

    The total is ``(out - 1) * stride + k - size`` and the smaller half
    goes *before*: for an even size at stride 2 that is no row at the
    top and one at the bottom, which ``F.conv2d(padding=1)`` gets wrong.
    """
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return out, total // 2, total - total // 2


def fp32_conv():
    """cuDNN runs float32 convolutions in TF32 by default, which keeps
    about three digits and breaks the 1e-4 agreement with the JAX
    package; this context pins full float32 (and deterministic
    algorithms, so a seeded training run repeats). Matmuls already run
    in float32: ``torch.backends.cuda.matmul.allow_tf32`` stays False."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                      deterministic=True)


def conv_scorer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                stride: int = 2) -> torch.Tensor:
    """3x3 SAME conv + bias + relu. x: (N, H, W, Cin); w: (3,3,Cin,Cout).

    The counterpart of ``repro/kernels/ref.py::conv_scorer``, in full
    float32 on the card (``fp32_conv``)."""
    _, H, W, _ = x.shape
    _, top, bottom = same_pad(H, stride)
    _, left, right = same_pad(W, stride)
    xp = F.pad(x.float().permute(0, 3, 1, 2), (left, right, top, bottom))
    with fp32_conv():
        out = F.conv2d(xp, w.float().permute(3, 2, 0, 1), stride=stride)
    out = torch.relu(out + b.float()[:, None, None])
    return out.permute(0, 2, 3, 1).contiguous().to(x.dtype)
