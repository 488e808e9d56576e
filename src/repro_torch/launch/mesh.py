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
  * the training mesh (``make_local_mesh(device, model=m)``):
    ``("data", "model")`` of ``(world_size / m, m)`` over the ranks of
    the default process group of ``torch.distributed``, one slot a
    process (1 with no process group). The model coordinate runs
    fastest: ranks ``d·m … d·m + m - 1`` form model group d, and ranks
    ``c, c + m, …`` data group c. A rank's mesh holds its data group
    and its model group and its coordinates on both axes.

And the dry run's meshes (``launch/dryrun.py``), which hold no devices:
only axis names and sizes. ``make_dryrun_mesh("card")`` is one card;
``"node"`` is ``{data: 8}``, the eight cards of one H100 node under the
placement the port runs over "data" (FSDP: each weight's "embed" dim
sliced over the ranks and gathered a block at a time, the batch split,
the gradients of the sliced weights reduce-scattered and those of the
others summed as ``train/train_step.sum_gradients`` does); ``"pod"``
and ``"multipod"`` are the JAX package's ``make_production_mesh``
shapes, ``{data: 16, model: 16}`` and ``{pod: 2, data: 16, model: 16}``
(32 and 64 nodes of 8 H100s), FSDP over "data" and the model split over
"model". They hold no group: a step is counted on ``meta`` for one
device, with the collectives the step calls counted and not sent
(``parallel/ops.py``), the gradient sums from the port's plan.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``devices``: one a slot of the data axis (for a mesh over
    processes, each rank's device in rank order; none for a dry run's
    mesh, which only names a shape); ``group``: the process group whose
    ranks are the data axis's slots (this rank's data group), or None
    when every slot is in this process or the data axis is 1 over
    processes; ``rank``: this process's coordinate on the data axis;
    ``model_group`` and ``model_rank``: this rank's group and coordinate
    on the "model" axis (None and 0 without one)."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...]
    shape: Dict[str, int]
    group: Optional[object] = None
    rank: int = 0
    model_group: Optional[object] = None
    model_rank: int = 0

    @property
    def size(self) -> int:
        n = 1
        for a in self.axis_names:
            n *= int(self.shape[a])
        return n

    @property
    def processes(self) -> int:
        """Processes the batch axes span: one a slot for a mesh over
        processes and for a dry run's mesh (no devices: each slot is a
        device of its own), 1 for a mesh of one process."""
        if self.group is None and self.devices:
            return 1
        n = 1
        for a in ("pod", "data"):
            n *= int(self.shape.get(a, 1))
        return n

    @property
    def data_slices(self) -> int:
        """The ranks the "data" axis slices the weights over (FSDP: the
        "embed" dims of ``parallel/sharding.default_rules``): the data
        axis of a mesh over processes or of a dry run's mesh, 1 for a
        mesh of one process."""
        return int(self.shape.get("data", 1)) if self.processes > 1 else 1


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


def make_local_mesh(device=None, model: int = 1) -> Mesh:
    """The ("data", "model") mesh of (world_size / model, model) over the
    ranks of the default process group, or one slot on ``device`` when
    there is no process group. Every rank passes its own ``device``; the
    devices are exchanged and every data group and model group is made
    (collectives, each group by every rank in the same order), so every
    rank calls this. A model axis larger than 1 needs that many
    processes: without a process group, or when ``model`` does not
    divide the world, this raises."""
    import torch.distributed as dist
    device = torch.device(device if device is not None else "cpu")
    if not (dist.is_available() and dist.is_initialized()):
        if model != 1:
            raise ValueError(f"a model axis of {model} needs {model} "
                             "processes of torch.distributed; none is "
                             "initialized")
        return Mesh((device,), ("data", "model"), {"data": 1, "model": 1})
    n, rank = dist.get_world_size(), dist.get_rank()
    if model < 1 or n % model:
        raise ValueError(f"a model axis of {model} does not divide the "
                         f"{n} ranks")
    names = [None] * n
    dist.all_gather_object(names, str(device))
    devices = tuple(torch.device(d) for d in names)
    if model == 1:
        return Mesh(devices, ("data", "model"), {"data": n, "model": 1},
                    group=dist.group.WORLD, rank=rank)
    data = n // model
    d, c = divmod(rank, model)
    data_groups = [dist.new_group([k + model * i for i in range(data)])
                   for k in range(model)] if data > 1 else None
    model_groups = [dist.new_group(list(range(i * model, (i + 1) * model)))
                    for i in range(data)]
    return Mesh(devices, ("data", "model"), {"data": data, "model": model},
                group=data_groups[c] if data_groups else None, rank=d,
                model_group=model_groups[d], model_rank=c)
