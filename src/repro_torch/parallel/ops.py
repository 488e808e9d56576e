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

The served placement. The JAX ``cache_shardings`` splits an attention
cache's sequence over "model", and at a batch of 1 over ("data",
"model"): the batch is then whole on every data rank, and the d·m ranks
of a data axis of d processes and a model axis of m hold the ring's rows
in that flat order, data major (rank (d, c) is shard d·m + c; a pod axis
holds the same rows again). ``serve_placement(mesh, batch)`` is that
rule, the one place it is decided: a rank's rows of a served global
batch and its cache axis (size, index). ``cache_size()`` and
``cache_rank()`` read it for the installed mesh and the served batch
that the step installs (``use_mesh(..., batch=)``); ``cache_parts(x)``
gathers ``x`` over the cache axis in its order (the model axis, then
the data group).

Each is the identity, or a list of one, without a model axis. There is
no all-reduce: its order of addition is the backend's, and with sums in
rank order every tensor replicated over "model" has the same bits on
every model rank.

FSDP over "data" (the JAX package's "embed" -> "data" rule). A model
built for a rank of a mesh whose data axis spans processes holds each
weight with an "embed" dim as its slice of that dim
(``models/transformer.py``), and gathers it where it is used:

  * ``data_gather(w, dim)``: the data ranks' slices concatenated on
    ``dim`` in rank order, so every rank holds the whole weight bit for
    bit; its backward is a reduce-scatter in a fixed order: for each
    rank k in turn, slice k of every rank's gradient all-gathered in
    float32, and rank k adds them rank 0 first and rounds once to the
    gradient's type, the bits that ``train/train_step.sum_gradients``
    gives for those elements. The n gathers move the bytes of one
    gather of the whole gradient and hold one whole gradient in float32
    at a time, not n of them (all-gathered, not sent with
    ``all_to_all``, which would move 1/n of the bytes but which gloo
    takes for CPU tensors only, nor with a ``reduce_scatter``, whose
    order of addition is the backend's);
  * ``data_sum(x)``: ``x`` summed over the data axis's slices in rank
    order (no gradient), for the gradient norm of sliced leaves;
  * ``data_slices()``, ``data_rank()``.

On ``meta`` (the dry run's meshes, which hold no group) nothing is
sent: the other ranks' tensors are only shaped. On a real tensor a
collective with no process group raises; none falls back to a local
copy. On every device each collective reports its kind and its output
bytes to the op count (``kernels/count.collective``).
"""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

from repro_torch.kernels import count

_STATE = {"mesh": None, "rules": None, "batch": None}


@contextlib.contextmanager
def use_mesh(mesh, rules: dict, batch: Optional[int] = None):
    """``mesh`` and its ``rules`` installed for the code it wraps.
    ``batch``: the global batch of the prefill or decode step run under
    it (None: no served step), which places the attention caches
    (``serve_placement``)."""
    prev = dict(_STATE)
    _STATE["mesh"] = mesh
    _STATE["rules"] = rules
    _STATE["batch"] = batch
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


def local_group_count() -> int:
    """Data-parallel groups this process holds: ``data_group_count()``
    over the processes the data axis spans (a dry run's mesh: one
    device's)."""
    mesh = _STATE["mesh"]
    return max(data_group_count() // (1 if mesh is None else
                                      mesh.processes), 1)


def data_ranks() -> int:
    """The processes the installed mesh's batch axes span
    (``Mesh.processes``: a dry run's mesh counts one a device), over
    which the loss's means and the router statistics are summed; 1
    without a mesh."""
    mesh = _STATE["mesh"]
    return 1 if mesh is None else mesh.processes


class _GatherSum(torch.autograd.Function):
    """The sum over the ranks of ``x``, added in rank order (every rank
    the same bits); its backward passes the gradient to the rank's own
    summand only, so each rank's graph holds the other ranks' values as
    constants and the sum of the ranks' gradients is the gradient of
    the global function."""

    @staticmethod
    def forward(ctx, x, group, n):
        return _rank_sum(_parts(x, group, n))

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def gather_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the installed mesh's ``data_ranks()`` (its
    group's ranks); ``x`` itself with one."""
    n = data_ranks()
    if n == 1:
        return x
    return _GatherSum.apply(x, _STATE["mesh"].group, n)


# -- FSDP over "data" ---------------------------------------------------------

def data_slices() -> int:
    """The ranks the installed mesh's "data" axis slices the weights over
    (``Mesh.data_slices``; 1 without a mesh)."""
    mesh = _STATE["mesh"]
    return 1 if mesh is None else mesh.data_slices


def data_rank() -> int:
    """This process's coordinate on the "data" axis (0 on ``meta``, whose
    count is one device's, and without a mesh)."""
    mesh = _STATE["mesh"]
    return 0 if mesh is None else mesh.rank


class _DataGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, dim, group, n, rank):
        ctx.dim, ctx.group, ctx.n, ctx.rank = dim, group, n, rank
        return torch.cat(_parts(w, group, n), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        size = grad.shape[ctx.dim] // ctx.n
        mine = None
        for k in range(ctx.n):
            parts = _parts(grad.narrow(ctx.dim, k * size, size).float(),
                           ctx.group, ctx.n)
            if k == ctx.rank:
                mine = _rank_sum(parts).to(grad.dtype)
            del parts
        return mine, None, None, None, None


def data_gather(w: torch.Tensor, dim: int) -> torch.Tensor:
    """The whole weight of this rank's slice ``w`` (sliced on ``dim`` over
    the installed mesh's "data" axis): the ranks' slices concatenated in
    rank order; the backward reduce-scatters the gradient in a fixed
    order (the module's docstring). Raises without a data axis to
    gather over."""
    n = data_slices()
    if n == 1:
        raise RuntimeError("data_gather: the installed mesh has no data "
                           "axis over processes; run a model sliced over "
                           "\"data\" under parallel/ops.use_mesh of its mesh")
    mesh = _STATE["mesh"]
    return _DataGather.apply(w, dim % w.dim(), mesh.group, n, mesh.rank)


@torch.no_grad()
def data_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the data axis's slices in rank order (``x``
    itself with one), no gradient."""
    n = data_slices()
    return x if n == 1 else _rank_sum(_parts(x, _STATE["mesh"].group, n))


@torch.no_grad()
def all_parts(x: torch.Tensor, group) -> list:
    """The ranks of ``group``'s ``x`` in rank order (no gradient)."""
    return _parts(x, group, torch.distributed.get_world_size(group))


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


# -- the cache axis ------------------------------------------------------------

def serve_placement(mesh, batch: Optional[int]) -> Tuple[int, Tuple[int,
                                                                      int]]:
    """(this rank's rows of a served global ``batch``, its cache axis:
    (size, this rank's index)) on ``mesh``. Where the batch axes span
    processes (or a dry run's view of them): a batch of 1 is whole on
    every data rank, its attention caches' sequence split over ("data",
    "model"), size d·m, index d·m + c; a larger batch is cut into equal
    rows a data rank, its caches split over "model", (m, c), and raises
    where it does not divide. One process: the whole batch, (m, c).
    Without a mesh: the whole batch, (1, 0). ``batch`` None (a mesh
    installed with no served batch) raises where it would decide."""
    if mesh is None:
        return batch, (1, 0)
    m, c = int(mesh.shape.get("model", 1)), mesh.model_rank
    p = mesh.processes
    if p == 1:
        return batch, (m, c)
    if batch is None:
        raise ValueError(f"the served batch over {p} data ranks is not "
                         "known: run the step under use_mesh(mesh, rules, "
                         "batch=) (train_step.make_prefill_step, "
                         "make_decode_step)")
    if batch == 1:
        return 1, (mesh.data_slices * m, mesh.rank * m + c)
    if batch % p:
        raise ValueError(f"a served batch of {batch} rows does not divide "
                         f"over {p} data-parallel ranks")
    return batch // p, (m, c)


def cache_size() -> int:
    """The installed mesh's cache axis (``serve_placement``); 1 without
    one."""
    return serve_placement(_STATE["mesh"], _STATE["batch"])[1][0]


def cache_rank() -> int:
    """This rank's index on the installed mesh's cache axis."""
    return serve_placement(_STATE["mesh"], _STATE["batch"])[1][1]


@torch.no_grad()
def cache_parts(x: torch.Tensor) -> list:
    """The cache axis's ranks' ``x`` in its order (no gradient): the
    model ranks' gathered, then those of every data rank over the data
    group (two gathers); ``model_parts`` where the axis is the model
    axis's."""
    parts = model_parts(x)
    n = cache_size() // model_size()
    if n == 1:
        return parts
    rows = _parts(torch.stack(parts), _STATE["mesh"].group, n)
    return [p for block in rows for p in block.unbind(0)]


@torch.no_grad()
def model_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over the model ranks (no gradient)."""
    parts = model_parts(x)
    out = parts[0]
    for p in parts[1:]:
        out = torch.maximum(out, p)
    return out
