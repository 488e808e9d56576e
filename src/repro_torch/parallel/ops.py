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

The "model" axis. The JAX package's ``shard`` (a GSPMD sharding
constraint) has no counterpart: PyTorch does not partition a program.
Where the JAX package pins an activation to the "model" axis and lets
GSPMD insert the collectives, the port's modules call them themselves
(``models/layers.py``, ``attention.py``, ``moe.py``, ``ssm.py``), over
the model group of the installed mesh (``launch/mesh.make_local_mesh(
device, model=m)``):

  * ``model_sum(x)``: the sum of the ranks' ``x``, all-gathered and
    added in rank order (every rank the same bits); its backward passes
    the gradient to the rank's own summand (the output of a row-split
    product);
  * ``model_copy(x)``: ``x`` itself; its backward is ``model_sum`` of
    the gradient (the input of a column-split product, so a replicated
    activation's gradient is the whole one on every rank);
  * ``model_gather(x, dim)``: the ranks' ``x`` concatenated on ``dim``
    in rank order; its backward takes the rank's slice;
  * ``model_max(x)`` (no gradient) and ``model_parts(x)`` (the ranks'
    tensors, no gradient), for a sharded log-sum-exp and the decode
    merge;
  * ``model_rank()``, ``model_size()``.

Each is the identity, or a list of one, without a model axis. There is
no all-reduce: its order of addition is the backend's, and with sums in
rank order every tensor replicated over "model" has the same bits on
every model rank. On ``meta`` (the dry run's ``pod`` and ``multipod``,
whose mesh holds no group) nothing is sent: the other ranks' tensors
are only shaped. On every device each collective reports its kind and
its output bytes to the op count (``kernels/count.collective``).
"""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

from repro_torch.kernels import count

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
    over the processes the data axis spans (a dry run's mesh: one
    device's)."""
    mesh = _STATE["mesh"]
    return max(data_group_count() // (1 if mesh is None else
                                      mesh.processes), 1)


class _GatherSum(torch.autograd.Function):
    """The sum over the ranks of ``x``, added in rank order (every rank
    the same bits); its backward passes the gradient to the rank's own
    summand only, so each rank's graph holds the other ranks' values as
    constants and the sum of the ranks' gradients is the gradient of
    the global function."""

    @staticmethod
    def forward(ctx, x, group):
        return _rank_sum(_parts(x, group,
                                torch.distributed.get_world_size(group)))

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


# -- the "model" axis ---------------------------------------------------------

def model_size() -> int:
    """The installed mesh's "model" axis (1 without one)."""
    mesh = _STATE["mesh"]
    return 1 if mesh is None else int(mesh.shape.get("model", 1))


def model_rank() -> int:
    """This process's coordinate on the "model" axis (0 on ``meta``,
    whose count is one device's, and without a mesh)."""
    mesh = _STATE["mesh"]
    return 0 if mesh is None else mesh.model_rank


def _parts(x: torch.Tensor, group, n: int) -> list:
    """The ``n`` ranks' ``x`` in rank order: all-gathered over ``group``,
    or shaped only on ``meta``. Raises on a real tensor with no process
    group."""
    x = x.contiguous()
    with (count.collective("all-gather", n * x.numel() * x.element_size())
          if count.ACTIVE else count.NOT_COUNTING):
        parts = [torch.empty_like(x) for _ in range(n)]
        if x.device.type != "meta":
            if group is None:
                raise RuntimeError(f"a gather over {n} ranks with no "
                                   "process group: build the mesh with "
                                   "launch/mesh.make_local_mesh")
            torch.distributed.all_gather(parts, x, group=group)
    return parts


def _rank_sum(parts: list) -> torch.Tensor:
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


def _model_parts(x: torch.Tensor) -> list:
    return _parts(x, _STATE["mesh"].model_group, model_size())


class _ModelSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _rank_sum(_model_parts(x))

    @staticmethod
    def backward(ctx, grad):
        return grad


class _ModelCopy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _rank_sum(_model_parts(grad))


class _ModelGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.size, ctx.rank = dim, x.shape[dim], model_rank()
        return torch.cat(_model_parts(x), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        return grad.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None


def model_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the model ranks in rank order (``x`` without a
    model axis); the backward passes the gradient to this rank's
    summand."""
    return x if model_size() == 1 else _ModelSum.apply(x)


def model_copy(x: torch.Tensor) -> torch.Tensor:
    """``x``; the backward sums the gradient over the model ranks."""
    return x if model_size() == 1 else _ModelCopy.apply(x)


def model_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The model ranks' ``x`` concatenated on ``dim`` in rank order; the
    backward takes this rank's slice."""
    if model_size() == 1:
        return x
    return _ModelGather.apply(x, dim % x.dim())


@torch.no_grad()
def model_parts(x: torch.Tensor) -> list:
    """The model ranks' ``x`` in rank order (no gradient)."""
    return [x] if model_size() == 1 else _model_parts(x)


@torch.no_grad()
def model_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over the model ranks (no gradient)."""
    parts = model_parts(x)
    out = parts[0]
    for p in parts[1:]:
        out = torch.maximum(out, p)
    return out
