"""AdamW's update as one hand-written CUDA launch: binding and wrapper.

``adamw_update(params, grads, m, v, decay, scale, lr, b1c, b2c, b1, b2,
eps, wd)`` updates every parameter and its moments in place, as
``train/optimizer.apply_updates`` asks after it has clipped. It replaces
no Pallas kernel: the JAX package's update is elementwise jnp code that
XLA fuses. On the card it is ``csrc/adamw.cu``, one launch over all the
tensors (the note there gives its design and its bound), which gives
the bits of the plain version, ``ref.adamw_update``: the eager loop a
parameter at a time. The step's scalars reach the kernel by value (lr,
b1c and b2c from their float32 host tensors; b1, 1 - b1, b2, 1 - b2,
eps and wd rounded to float32 as PyTorch rounds a scalar for a float32
tensor) and the clip factor through its address on the card, so nothing
waits for the card.

The route follows the tensors' device. The CPU's go to the plain
version. The card's launch the kernel or raise: there is no fallback.
``meta``'s (the dry run) are checked as the card's would be and nothing
is computed. ``cost`` gives the update's operations and bytes, which
the wrapper reports to the op count (``kernels/count.py``) when one is
active, on every device.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import build, count, ref

CHUNK = 16384     # elements a block takes at a time: 256 threads x 8 values x 8
DECAY, ALIGNED, BF16 = 1, 2, 4     # a table row's flags (csrc/adamw.cu)
SIGNATURES = {"adamw_update": [
    ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
    ctypes.c_void_p] + [ctypes.c_float] * 9 + [ctypes.c_void_p]}


def cost(params: Sequence[torch.Tensor], decay: Sequence[bool]):
    """(operations, bytes) of one update: 15 float32 operations an
    element, 17 where the parameter decays; p, g, m and v read once and
    p, m and v written once (28 bytes an element in float32, 22 with a
    bf16 parameter)."""
    flops = nbytes = 0
    for p, d in zip(params, decay):
        n = p.numel()
        flops += (17 if d else 15) * n
        nbytes += (3 * p.element_size() + 16) * n
    return flops, nbytes


def plan(numels: Sequence[int], chunk: int = CHUNK) -> Tuple[List[int], int]:
    """Each tensor's first chunk among all the tensors' chunks of
    ``chunk`` elements, in order, and the number of chunks: an empty
    tensor takes none, and shares its first chunk with the next."""
    first, c = [], 0
    for n in numels:
        first.append(c)
        c += -(-n // chunk)
    return first, c


def adamw_update(params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], m: Sequence[torch.Tensor],
                 v: Sequence[torch.Tensor], decay: Sequence[bool],
                 scale: torch.Tensor, lr: torch.Tensor, b1c: torch.Tensor,
                 b2c: torch.Tensor, b1: float, b2: float, eps: float,
                 wd: float) -> None:
    """AdamW's update of each parameter of ``params`` and its float32
    moments ``m`` and ``v``, in place, with its gradient of ``grads`` (the
    parameter's type) times ``scale`` (0-d float32 on their device); ``lr``,
    ``b1c`` and ``b2c`` 0-d float32 host tensors; ``decay`` each
    parameter's flag. ``adamw_update.launches`` counts the kernel's
    launches."""
    dev = scale.device
    n = sum(p.numel() for p in params)
    with (count.kernel("adamw", cost(params, decay), torch.float32)
          if count.ACTIVE else count.NOT_COUNTING):
        if dev.type == "cpu":
            ref.adamw_update(params, grads, m, v, decay, scale, lr, b1c,
                             b2c, b1, b2, eps, wd)
            return
        _check(params, grads, m, v, scale)
        # a tensor that is not contiguous (a view of a larger weight) is
        # updated in a contiguous copy, which is then copied back: the
        # update is elementwise, so the bits are the same
        back = []

        def dense(t, written=True):
            if t.is_contiguous():
                return t
            c = t.contiguous()
            if written:
                back.append((t, c))
            return c
        params, m, v = ([dense(t) for t in ts] for ts in (params, m, v))
        grads = [dense(g, False) for g in grads]
        if dev.type == "cuda" and n:
            _launch(params, grads, m, v, decay, scale,
                    [_f32(x) for x in (b1, 1 - b1, b2, 1 - b2, eps, wd)] +
                    [float(t) for t in (lr, b1c, b2c)])
        for t, c in back:
            t.copy_(c)


def _f32(x: float) -> float:
    """``x`` rounded to float32, as PyTorch rounds a Python scalar for a
    float32 tensor."""
    return float(np.float32(x))


def _check(params, grads, m, v, scale) -> None:
    dev = scale.device
    if dev.type not in ("cuda", "meta"):
        raise ValueError(f"adamw_update runs on cpu, cuda or meta, not {dev}")
    if scale.dtype != torch.float32 or scale.numel() != 1:
        raise TypeError("the clip factor is one float32 value")
    if not len(params) == len(grads) == len(m) == len(v):
        raise ValueError("a gradient, m and v for every parameter")
    for p, g, mi, vi in zip(params, grads, m, v):
        build.dtype_code(p, g)
        if mi.dtype != torch.float32 or vi.dtype != torch.float32:
            raise TypeError("AdamW's moments are float32")
        if not p.shape == g.shape == mi.shape == vi.shape:
            raise ValueError(f"parameter {tuple(p.shape)}, gradient "
                             f"{tuple(g.shape)}, m {tuple(mi.shape)}, v "
                             f"{tuple(vi.shape)}")
        if any(t.device != dev for t in (p, g, mi, vi)):
            raise ValueError(f"every tensor on the clip factor's {dev}")


def _launch(params, grads, m, v, decay, scale, scalars) -> None:
    dev = scale.device
    numels = [p.numel() for p in params]
    first, chunks = plan(numels, CHUNK)
    rows = torch.empty((len(params), 8), dtype=torch.int64, pin_memory=True)
    table = rows.numpy()
    for i, (p, g, mi, vi, d) in enumerate(zip(params, grads, m, v, decay)):
        ptrs = [t.data_ptr() for t in (p, g, mi, vi)]
        flags = (DECAY if d else 0) | (BF16 if p.dtype == torch.bfloat16
                                       else 0)
        if all(a % 16 == 0 for a in ptrs):
            flags |= ALIGNED
        table[i] = ptrs + [numels[i], first[i], flags, 0]
    # the pinned rows are not reused until the copy has run
    table_d = rows.to(dev, non_blocking=True)
    build.launch(build.load("adamw", SIGNATURES).adamw_update, dev,
                 table_d.data_ptr(), len(params), chunks, CHUNK,
                 scale.data_ptr(), *scalars,
                 what=f"adamw_update of {len(params)} tensors")
    adamw_update.launches += 1


adamw_update.launches = 0
