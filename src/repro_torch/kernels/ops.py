"""Device rule and kernel dispatch for the port.

``resolve_device`` is the one place that says where an entry point runs:
on the card unless the caller asks for the CPU, and never quietly on the
CPU when there is no card. ``conv_scorer_fn`` gives the scoring runtime
its conv scorer once, when the runtime is built; ``scorer_head`` is the
scorer's dense and head layers, the kernel's wrapper.

``rmsnorm``, ``attention``, ``decode_attention`` and ``moe_gmm`` are
what the LM zoo's model calls for its norms, its prefill attention, its
decode attention and its MoE expert products (the JAX package's
``use_pallas`` hot paths): each is the
kernel's wrapper, which sends a CPU tensor to the plain version and
launches the CUDA kernel on a CUDA tensor, or raises; a ``meta`` tensor
(the dry run, ``launch/dryrun.py``) gets an empty result of the card's
shape and strides, and every wrapper reports its kernel's ``cost`` to
the op count (``kernels/count.py``) when one is active. Under autograd
``rmsnorm``, ``attention`` and ``moe_gmm`` go through their modules'
``autograd.Function``s, whose backward passes are hand-written kernels
too (the plain backward passes of ``kernels/ref.py`` on the CPU).
"""
from __future__ import annotations

import functools
from typing import Callable, Union

import torch

from repro_torch.kernels import conv_scorer as _conv
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import scorer_head as _head

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


scorer_head = _head.scorer_head
rmsnorm = _rms.rmsnorm
attention = _fa.flash_attention
decode_attention = _dec.decode_attention
moe_gmm = _gmm.moe_gmm
