"""Train / eval / prefill / decode step functions.

Ported from ``repro/train/train_step.py``. ``make_train_step(cfg,
opt_cfg)`` returns a plain function (model, opt_state, batch) -> (model,
opt_state, metrics): the loss and its gradients by autograd through the
model's kernels (each with its backward kernel on the card), then one
AdamW step (``train/optimizer.py``) that updates the model's parameters
in place. The JAX package's ``jax.value_and_grad`` + ``jit`` has no
other counterpart here: PyTorch runs eagerly. ``deterministic`` is the
training path's setting on the card: index backward passes (the
embedding lookup's, the MoE dispatch's gather of a token's k copies)
scatter with float atomics unless PyTorch's deterministic algorithms
are on, and a resumed run must repeat an uninterrupted one bit for bit.

Data parallelism (``make_train_step(..., mesh=...)`` with a mesh of
``launch/mesh.make_local_mesh`` over the ranks of ``torch.distributed``,
and the model built for the rank: ``transformer.init_model(...,
mesh=...)``): FSDP over "data", the JAX package's placement. Each rank
holds its slice of every weight with an "embed" dim, and of AdamW's m
and v; it takes its rows of the global batch (``shard_batch``) and runs
the JAX package's program for them under ``parallel/ops.use_mesh`` (its
MoE dispatch one group of the rank's tokens; the loss's means and the
router statistics summed over the ranks, so each rank's gradient is its
share of the global one), gathering each block's weights in rank order
where the block runs (again in a rematerialised block's backward). The
backward reduce-scatters the gradient of each sliced weight to the
rank's slice, and the gradients of the weights every rank holds whole
are summed by ``sum_gradients``; both add the ranks' float32 gradients
rank 0 first, so every rank holds the same bits whatever the
collective's reduction tree (a slice the bits of ``sum_gradients``'
sum of the whole), and clipping and AdamW then update each slice as one
process's update of the whole would. A model built without the mesh
(every weight whole) runs the same step with every gradient summed by
``sum_gradients``.

The "model" axis (a mesh of ``make_local_mesh(device, model=m)``): the
rank takes the rows of its data coordinate, runs its slice of the model
under the mesh (the model axis's collectives inside the model), reduces
its gradients over its data group only, and AdamW clips by the whole
model's norm (``optimizer.global_norm`` over the model's
``split_axes()``). The prefill and decode steps run under the mesh too,
on the rows of the rank's data coordinate, the weights gathered a block
at a time; a served batch of 1 is whole on every data rank instead, its
attention caches split over ("data", "model") (``serve_rows``).
"""
from __future__ import annotations

import contextlib
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from repro_torch import spans
from repro_torch.models import transformer
from repro_torch.parallel import ops as pops
from repro_torch.parallel import sharding
from repro_torch.train import optimizer as opt

BUCKET_BYTES = 256 << 20      # a rank's share of one gradient all-gather


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms on, an operation that has none
    raising instead of changing bits quietly, without filling fresh
    tensors with NaN (no operation of a training step reads memory it
    never wrote: ``benchmarks/torch_step_bits.py`` runs the step with the
    fill on and gets the same bits); the previous settings restored on
    exit. cuBLAS needs ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the
    environment before its first handle (``launch/train.py`` sets it)."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    det = getattr(torch.utils, "deterministic", None)
    fill = getattr(det, "fill_uninitialized_memory", None)
    torch.use_deterministic_algorithms(True, warn_only=False)
    if fill is not None:
        det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        if fill is not None:
            det.fill_uninitialized_memory = fill


def to_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A pipeline batch (NumPy ``tokens`` and ``labels`` (B, S), optional
    ``prefix_embeds``) as tensors on ``device``, the token ids int64."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v)) if not isinstance(
            v, torch.Tensor) else v
        out[k] = (t.long() if k in ("tokens", "labels") else t).to(device)
    return out


def _check(cfg, model) -> None:
    if model.cfg != cfg:
        raise ValueError(f"the step was built for {cfg.name}, the model is "
                         f"{model.cfg.name} or another config of it")


def shard_batch(mesh, batch: Mapping) -> Dict:
    """This rank's rows of a global batch: rows ``[r·B/n, (r+1)·B/n)`` of
    every leaf that ``sharding.data_batch_specs`` splits on dim 0 over the
    mesh's data axis of n processes (on a dry run's view of a mesh, its
    device's). A batch leaf whose rows do not divide raises: replicated,
    its gradient would be added n times."""
    if mesh is None or mesh.processes == 1:
        return dict(batch)
    n, r = mesh.processes, mesh.rank
    specs = sharding.data_batch_specs(mesh, batch)
    out = {}
    for k, v in batch.items():
        if not specs[k] or specs[k][0] is None:
            raise ValueError(f"the batch's {k} {tuple(v.shape)} does not "
                             f"divide over {n} data-parallel ranks")
        b = v.shape[0] // n
        out[k] = v[r * b:(r + 1) * b]
    return out


def gradient_buckets(numels, bucket_bytes: int = BUCKET_BYTES):
    """The buckets ``sum_gradients`` sends for gradients of ``numels``
    values, in order: each a list of (gradient's index, start, count),
    at most ``bucket_bytes`` of float32 a rank. ``launch/op_analysis.
    collective_plan`` counts the same buckets."""
    room = max(bucket_bytes // 4, 1)
    buckets = []
    i, off = 0, 0               # the gradient and the offset the next bucket starts at
    while i < len(numels):
        pieces, size = [], 0    # (index, start, count) a bucket holds
        while i < len(numels) and size < room:
            take = min(numels[i] - off, room - size)
            pieces.append((i, off, take))
            size += take
            off += take
            if off == numels[i]:
                i, off = i + 1, 0
        buckets.append(pieces)
    return buckets


@torch.no_grad()
def sum_gradients(grads: Mapping[str, torch.Tensor], group,
                  bucket_bytes: int = BUCKET_BYTES) -> None:
    """Every gradient replaced, in place, by its sum over the ranks of
    ``group``: the gradients, flattened in their order, are all-gathered
    in float32 buckets of at most ``bucket_bytes`` a rank
    (``gradient_buckets``) and added rank 0 first, so every rank gets
    the same bits."""
    n = torch.distributed.get_world_size(group)
    if not all(g.is_contiguous() for g in grads.values()):
        raise ValueError("the gradients are summed in place: each must be "
                         "contiguous")
    views = [g.view(-1) for g in grads.values()]
    if not sum(v.numel() for v in views):
        return
    dev = views[0].device
    for pieces in gradient_buckets([v.numel() for v in views], bucket_bytes):
        size = sum(k for _, _, k in pieces)
        send = torch.empty(size, dtype=torch.float32, device=dev)
        o = 0
        for j, start, k in pieces:
            send[o:o + k] = views[j][start:start + k]
            o += k
        parts = [torch.empty_like(send) for _ in range(n)]
        torch.distributed.all_gather(parts, send, group=group)
        acc = parts[0]
        for part in parts[1:]:
            acc += part
        o = 0
        for j, start, k in pieces:
            views[j][start:start + k] = acc[o:o + k]
            o += k
        del send, parts, acc


def loss_and_grads(model, batch, mesh=None, step: Optional[int] = None):
    """The loss of ``batch`` and every parameter's gradient (a dict in
    ``named_parameters`` order, zeros for a parameter the loss does not
    reach). With a mesh over processes: this rank's rows, the global
    loss, and the gradients summed over the ranks (a sliced weight's,
    this rank's slice of the sum). ``step``: the training step its spans
    (``train.input``, ``train.fwd``, ``train.bwd``) are recorded under."""
    params = dict(model.named_parameters())
    for p in params.values():
        p.grad = None
    dev = model.device
    with spans.span("train.input", step):
        batch = to_batch(shard_batch(mesh, batch), dev)
    with _mesh(mesh):
        with spans.span("train.fwd", step, dev):
            loss = transformer.train_loss(model, batch)
        with spans.span("train.bwd", step, dev):
            loss.backward()
    grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
             for n, p in params.items()}
    for p in params.values():
        p.grad = None
    if mesh is not None and mesh.group is not None:
        # a sliced weight's gradient was reduce-scattered in the backward
        sum_gradients({n: g for n, g in grads.items()
                       if n not in model.data_dims}, mesh.group)
    return loss.detach(), grads


def _mesh(mesh, batch: Optional[int] = None):
    """``parallel/ops.use_mesh`` of ``mesh`` with its rules and the served
    global ``batch`` (nothing without a mesh)."""
    return pops.use_mesh(mesh, sharding.default_rules(mesh), batch) \
        if mesh is not None else contextlib.nullcontext()


def serve_rows(mesh, batch: Mapping) -> Dict:
    """This rank's rows of a served global batch
    (``parallel/ops.serve_placement``): a batch of 1 whole on every data
    rank, any other cut by ``shard_batch``."""
    rows, _ = pops.serve_placement(mesh, len(batch["tokens"]))
    return dict(batch) if rows == len(batch["tokens"]) else \
        shard_batch(mesh, batch)


def make_train_step(cfg, opt_cfg: opt.AdamWConfig, mesh=None):
    """``mesh``: None for one process, or a mesh of
    ``launch/mesh.make_local_mesh`` (data-parallel over its data axis,
    the model split over its model axis)."""
    def train_step(model, opt_state: opt.OptState, batch):
        _check(cfg, model)
        step = opt_state.step
        loss, grads = loss_and_grads(model, batch, mesh, step)
        with _mesh(mesh), spans.span("train.optimizer", step, model.device):
            _, opt_state, metrics = opt.apply_updates(
                opt_cfg, dict(model.named_parameters()), grads, opt_state,
                decay=model.decay_mask(), split=model.split_axes())
        del grads
        return model, opt_state, dict(metrics, loss=loss)
    return train_step


def make_prefill_step(cfg, mesh=None, cache_len=None):
    """``mesh``: run under it, on this rank's rows of the global batch
    (``serve_rows``: a batch of 1 whole on every data rank, its caches
    split over ("data", "model")); ``cache_len``: the caches as rings of
    that many rows (``transformer.prefill``)."""
    def prefill_step(model, batch):
        _check(cfg, model)
        b = to_batch(serve_rows(mesh, batch), model.device)
        with _mesh(mesh, len(batch["tokens"])):
            return transformer.prefill(model, b["tokens"],
                                       b.get("prefix_embeds"), cache_len)
    return prefill_step


def make_decode_step(cfg, mesh=None):
    """``mesh``: run under it, on this rank's rows and caches (as
    ``make_prefill_step``'s)."""
    def decode_step(model, caches, batch):
        _check(cfg, model)
        b = to_batch(serve_rows(mesh, batch), model.device)
        with _mesh(mesh, len(batch["tokens"])):
            return transformer.decode_step(model, caches, b["tokens"],
                                           b["pos"])
    return decode_step


def make_eval_step(cfg):
    def eval_step(model, batch):
        _check(cfg, model)
        with torch.no_grad():
            return transformer.train_loss(model, to_batch(batch, model.device))
    return eval_step
