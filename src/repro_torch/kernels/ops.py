"""Device rule and kernel dispatch for the port.

``resolve_device`` is the one place that says where an entry point runs:
on the card unless the caller asks for the CPU, and never quietly on the
CPU when there is no card. ``conv_scorer_fn`` gives the scoring runtime
its conv scorer once, when the runtime is built.
"""
from __future__ import annotations

import functools
from typing import Callable, Union

import torch

from repro_torch.kernels import conv_scorer as _conv

Device = Union[str, torch.device, None]


def resolve_device(device: Device = None) -> torch.device:
    """``None`` means the card; raises where there is none."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path on the host")
        return torch.device("cuda")
    return torch.device(device)


def conv_scorer_fn(device: Device = None, *, stride: int = 2) -> Callable:
    """The conv scorer for ``device``: the CUDA kernel's wrapper, which
    itself sends CPU tensors to the plain version and launches the
    kernel on CUDA tensors."""
    device = resolve_device(device)
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"no conv scorer for device {device}")
    return functools.partial(_conv.conv_scorer, stride=stride)
