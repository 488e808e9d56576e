"""The hand-written kernels' and the collectives' share of the op count.

The op count (``launch/op_analysis.py``) sees aten ops through a
dispatch mode, but not a kernel: ``build.launch`` is a raw-pointer call.
So each kernel wrapper reports its kernel's ``cost`` (FLOPs, bytes) here
while a counter is active, on every device: the card's launch, the
CPU's plain version, ``meta``'s empty result. A wrapper tests ``ACTIVE``
itself and builds nothing when no counter is in use:

    with (count.kernel("rmsnorm", cost(x.shape, x.dtype), x.dtype)
          if count.ACTIVE else count.NOT_COUNTING):
        ...

A collective of the model axis (``parallel/ops.py``) reports its kind
and its output bytes through ``collective`` in the same way, on every
device: sent over a process group, or only shaped on ``meta``.
"""
from __future__ import annotations

import contextlib
from typing import List, Tuple

import torch

# the counters in use, innermost last (``op_analysis.count`` pushes them);
# a counter has ``add_kernel(name, flops, nbytes, flop_class)`` and an
# integer ``paused``, above 0 while its aten count is suspended
ACTIVE: List = []

NOT_COUNTING = contextlib.nullcontext()


class kernel:
    """A kernel wrapper's body under the innermost active counter: the
    kernel's ``cost`` (FLOPs, bytes) is added under ``name``, held to the
    bf16 peak when ``dtype`` is bf16 or fp16 (else fp32's), and the aten
    ops of the body (its outputs' allocation, the CPU's plain version)
    are not counted."""

    __slots__ = ("counter",)

    def __init__(self, name: str, cost: Tuple[int, int],
                 dtype: torch.dtype):
        self.counter = ACTIVE[-1]
        flops, nbytes = cost
        self.counter.add_kernel(name, flops, nbytes, "bfloat16" if dtype in (
            torch.bfloat16, torch.float16) else "float32")

    def __enter__(self) -> None:
        self.counter.paused += 1

    def __exit__(self, *exc) -> None:
        self.counter.paused -= 1


class collective(kernel):
    """A collective's body under the innermost active counter: ``kind``
    (``all-gather``) and its output bytes a device are added to the
    counter's collectives, and the aten ops of the body (the receive
    buffers, the backend's own copies) are not counted."""

    __slots__ = ()

    def __init__(self, kind: str, nbytes: int):
        self.counter = ACTIVE[-1]
        self.counter.add_collective(kind, nbytes)
