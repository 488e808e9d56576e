"""The installed mesh context, and the data-parallel sums model code needs.

Ported from ``repro/parallel/ops.py``: ``use_mesh(mesh, rules)``
installs a mesh for the code it wraps, and ``data_group_count()`` is
the number of data-parallel shards of that mesh (1 without one), which
the MoE dispatch routes within (``models/moe.py``).

The JAX package's program is global: one controller traces it over
every device, and its MoE dispatch forms ``data_group_count()`` groups
of the global batch. A mesh of the port whose data axis spans processes
(``launch/mesh.make_local_mesh`` under ``torch.distributed``) runs that
program once a rank, on the rank's rows: ``local_group_count()`` is the
groups a process holds (the global count over the processes), and the
statistics the JAX program takes over the global batch (the MoE
router's densities and top-1 counts, the mean losses) are summed over
the ranks with ``gather_sum``.

The JAX package's ``shard`` (a GSPMD sharding constraint) has no
counterpart: PyTorch does not partition a program, so there is nothing
to constrain, and the port's models never called it.
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

_STATE = {"mesh": None, "rules": None}


@contextlib.contextmanager
def use_mesh(mesh, rules: dict):
    prev = dict(_STATE)
    _STATE["mesh"] = mesh
    _STATE["rules"] = rules
    try:
        yield
    finally:
        _STATE.update(prev)


def data_group_count() -> int:
    """Number of data-parallel shards in the installed mesh context (1
    without a mesh)."""
    mesh, rules = _STATE["mesh"], _STATE["rules"]
    if mesh is None:
        return 1
    size = 1
    for a in rules.get("batch", ()):
        size *= mesh.shape[a]
    return size


def data_process_group():
    """The process group of the installed mesh when its data axis spans
    processes (one or more), else None."""
    mesh = _STATE["mesh"]
    return None if mesh is None else mesh.group


def local_group_count() -> int:
    """Data-parallel groups this process holds: ``data_group_count()``
    over the processes the data axis spans."""
    mesh = _STATE["mesh"]
    procs = 1 if data_process_group() is None else mesh.processes
    return max(data_group_count() // procs, 1)


class _GatherSum(torch.autograd.Function):
    """The sum over the ranks of ``x``, added in rank order (every rank
    the same bits); its backward passes the gradient to the rank's own
    summand only, so each rank's graph holds the other ranks' values as
    constants and the sum of the ranks' gradients is the gradient of
    the global function."""

    @staticmethod
    def forward(ctx, x, group):
        parts = [torch.empty_like(x) for _ in
                 range(torch.distributed.get_world_size(group))]
        torch.distributed.all_gather(parts, x.contiguous(), group=group)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def gather_sum(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` summed over the ranks of ``group`` (default: the installed
    mesh's, ``data_process_group``); ``x`` itself with no group."""
    group = group if group is not None else data_process_group()
    if group is None:
        return x
    return _GatherSum.apply(x, group)


def data_ranks(group: Optional[object] = None) -> int:
    """Ranks of ``group`` (default: the installed mesh's), 1 without."""
    group = group if group is not None else data_process_group()
    return 1 if group is None else torch.distributed.get_world_size(group)
