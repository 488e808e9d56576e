"""Device meshes of the port.

Ported from ``repro/launch/mesh.py``. A ``Mesh`` is a small value: the
names of its axes, their sizes, and one ``torch.device`` a slot of the
data axis. Two kinds are built here:

  * the scoring mesh (``make_scoring_mesh``): a 1-D ``("data",)`` mesh
    over devices of this process, over which ``core/runtime``'s
    ``OperatorRuntime(mesh=...)`` splits superbatches. A device may be
    named more than once, each entry one slot: the counterpart of the
    forced host devices the JAX package's tests score on, so the split
    runs on the CPU (``["cpu"] * 4``) and on one card
    (``["cuda:0", "cuda:0"]``);
  * the training mesh (``make_local_mesh``): ``("data", "model")`` of
    ``(world_size, 1)`` over the ranks of the default process group of
    ``torch.distributed``, one slot a process (1 with no process group).

And the dry run's meshes (``launch/dryrun.py``), which hold no devices:
only axis names and sizes. ``make_dryrun_mesh("card")`` is one card;
``"node"`` is ``{data: 8}``, the eight cards of one H100 node under the
data-parallel placement the port runs (parameters replicated, the batch
split, gradients all-gathered and summed as ``train/train_step.
sum_gradients`` does); ``"pod"`` and ``"multipod"`` are the JAX
package's ``make_production_mesh`` shapes, ``{data: 16, model: 16}``
and ``{pod: 2, data: 16, model: 16}`` (32 and 64 nodes of 8 H100s),
whose "model" axis the port does not execute.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: one a slot of the data axis (for a mesh over
    processes, each rank's device, this process's at ``rank``; none for
    a dry run's mesh, which only names a shape); ``group``: the process
    group whose ranks are the data axis's slots, or None when every slot
    is in this process."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    group: Optional[object] = None
    rank: int = 0

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_names:
            n *= int(self.shape[a])
        return n

    @property
    def processes(self) -> int:
        """Processes the data axis spans (1 for a mesh of one process)."""
        return len(self.devices) if self.group is not None else 1


def make_production_mesh(multi_pod: bool = False) -> Mesh:
    """The JAX package's production mesh shape, with no devices: 16 x 16
    ("data", "model"), or 2 x 16 x 16 ("pod", "data", "model")."""
    if multi_pod:
        return Mesh((), ("pod", "data", "model"),
                    {"pod": 2, "data": 16, "model": 16})
    return Mesh((), ("data", "model"), {"data": 16, "model": 16})


DRYRUN_MESHES = ("card", "node", "pod", "multipod")


def make_dryrun_mesh(name: str) -> Mesh:
    """One of ``DRYRUN_MESHES``, with no devices."""
    if name == "card":
        return Mesh((), ("data",), {"data": 1})
    if name == "node":
        return Mesh((), ("data",), {"data": 8})
    if name in ("pod", "multipod"):
        return make_production_mesh(multi_pod=name == "multipod")
    raise ValueError(f"unknown mesh {name!r}; one of {DRYRUN_MESHES}")


def make_scoring_mesh(devices: Optional[Sequence] = None) -> Optional[Mesh]:
    """1-D ("data",) mesh for device-parallel operator scoring.

    ``devices``: a list of devices or their names, one a slot (repeats
    allowed); None means every local CUDA device. Returns None when
    there is one slot or fewer, so callers can pass the result straight
    to ``OperatorRuntime(mesh=...)`` and get the unsharded path when
    there is nothing to split."""
    if devices is None:
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(torch.device(d) for d in devices)
    if len(devs) <= 1:
        return None
    return Mesh(devs, ("data",), {"data": len(devs)})


def make_local_mesh(device=None) -> Mesh:
    """The trainer's ("data", "model") mesh of (world_size, 1): one slot
    a rank of the default process group, or one slot on ``device`` when
    there is no process group. Every rank passes its own ``device``; the
    devices are exchanged (a collective), so every rank calls this."""
    import torch.distributed as dist
    device = torch.device(device if device is not None else "cpu")
    if not (dist.is_available() and dist.is_initialized()):
        return Mesh((device,), ("data", "model"), {"data": 1, "model": 1})
    n, rank = dist.get_world_size(), dist.get_rank()
    names = [None] * n
    dist.all_gather_object(names, str(device))
    return Mesh(tuple(torch.device(d) for d in names), ("data", "model"),
                {"data": n, "model": 1}, group=dist.group.WORLD, rank=rank)
