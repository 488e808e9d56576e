"""Logical-axis -> mesh-axis sharding rules.

Ported from ``repro/parallel/sharding.py``. A spec is a tuple with one
entry per dim: ``None`` (replicated), a mesh axis name, or a tuple of
names, the content of the JAX package's ``PartitionSpec``. The rules
resolve a leaf's logical axes to a spec for a mesh (anything with
``axis_names`` and a ``shape`` dict, such as ``launch/mesh.Mesh``), with
divisibility guards: a dim whose size does not divide by the mapped
mesh-axis product falls back to replicated, and the fallback is
recorded for ``explain_fallbacks``.

Default rules:
  embed  -> "data"; vocab/heads/kv_heads/ffn/expert -> "model"
  batch  -> ("pod", "data") as far as the mesh has them

The port runs them all (``default_rules``, the JAX placement): the
batch rule (``data_batch_specs``: the rows a data-parallel rank trains
on), the scoring rules below, "embed" over "data" (FSDP: every weight
with an "embed" dim held as each data rank's slice of it, gathered
where it is used, ``parallel/ops.data_gather``) and vocab, heads, kv
heads, ffn and experts over "model". ``param_shardings`` and
``cache_shardings`` place the parameters (the JAX layout of
``models/transformer.py::param_specs``) and the decode caches (stacked
over periods, ``launch/specs.stacked_caches``) by the rules, as the JAX
package's do, fallbacks recorded; ``local_shard`` cuts a rank's block
of a leaf by its spec, which is how a model is built for one rank of a
mesh (``models/transformer.py``: the model axis's blocks before a layer
is built, then each weight's slice over "data"). The dry run
(``launch/dryrun.py``) reads them for the per-device bytes of the JAX
placement (``jax_memory``) beside the port's.
"""
from __future__ import annotations

from typing import Dict, Tuple

Spec = Tuple[object, ...]


def default_rules(mesh) -> Dict[str, Tuple[str, ...]]:
    names = mesh.axis_names
    batch = tuple(a for a in ("pod", "data") if a in names)
    return {
        "embed": ("data",),
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "ffn": ("model",),
        "expert": ("model",),
        "batch": batch,
        "head_dim": (),
        "layer": (),
    }


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_shard(t, spec: Spec, mesh, coords: Dict[str, int]):
    """This rank's block of ``t`` placed by ``spec``: each dim whose
    entry names mesh axes that ``coords`` (axis -> this rank's
    coordinate) all hold is cut into the axes' product of equal blocks
    and the block at the coordinates (the first axis of the entry the
    slowest) is kept; every other dim is whole. A view of ``t``."""
    for dim, entry in enumerate(spec):
        axes = _entry_axes(entry)
        if not axes or any(a not in coords for a in axes):
            continue
        k, i = 1, 0
        for a in axes:
            k *= int(mesh.shape[a])
            i = i * int(mesh.shape[a]) + int(coords[a])
        n = t.shape[dim]
        if n % k:
            raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                             f"divide over {axes} of {k}")
        t = t.narrow(dim, i * (n // k), n // k)
    return t


def _axis_size(mesh, axes: Tuple[str, ...]) -> int:
    size = 1
    for a in axes:
        size *= int(mesh.shape[a])
    return size


def spec_for_leaf(shape, axes, mesh, rules, fallbacks=None) -> Spec:
    entries = []
    for dim, ax in zip(shape, axes):
        mapped = rules.get(ax, ()) if ax is not None else ()
        if mapped and dim % _axis_size(mesh, mapped) == 0:
            entries.append(mapped if len(mapped) > 1 else mapped[0])
        else:
            if mapped and fallbacks is not None:
                fallbacks.append((ax, dim, mapped))
            entries.append(None)
    return tuple(entries)


def param_shardings(specs, mesh, rules=None, collect_fallbacks=None):
    """``specs``: the ``ParamSpec``s of ``models/transformer.py::
    param_specs`` (JAX shapes and logical axes). Returns their specs in
    the same order; a dim the mapped mesh axes do not divide replicates,
    recorded in ``collect_fallbacks``."""
    rules = rules if rules is not None else default_rules(mesh)
    return [spec_for_leaf(p.shape, p.axes, mesh, rules, collect_fallbacks)
            for p in specs]


def cache_shardings(cfg, caches_shapes, mesh, batch: int):
    """Decode KV-cache specs, as the JAX package's: ``caches_shapes`` a
    tree (tuples, lists, dicts) whose leaves have a ``shape``, in the JAX
    layout (stacked over periods). Attention k/v caches (periods, B, S,
    KV, D): batch over ("pod", "data") when it divides (and B > 1);
    cache seq over "model" (B > 1) or ("data", "model") (B == 1) when it
    divides. Mamba's h (periods, B, di, N): d_inner over "model" when it
    divides. Returns the same tree of specs."""
    names = mesh.axis_names
    bax = tuple(a for a in ("pod", "data") if a in names)
    b_ok = batch % _axis_size(mesh, bax) == 0 and batch > 1

    def seq_axes(seq_dim: int):
        cand = ("data", "model") if batch == 1 else ("model",)
        return cand if seq_dim % _axis_size(mesh, cand) == 0 else ()

    def one(leaf):
        shp = tuple(leaf.shape)
        spec = [None] * len(shp)
        if len(shp) >= 2 and shp[1] == batch and b_ok:
            spec[1] = bax if len(bax) > 1 else bax[0]
        if len(shp) == 5:                      # (periods,B,S,KV,D) attn cache
            sa = seq_axes(shp[2])
            if sa:
                spec[2] = sa if len(sa) > 1 else sa[0]
        if len(shp) == 4 and shp[-1] != shp[-2]:  # (periods,B,di,N) mamba h
            if shp[2] % mesh.shape["model"] == 0:
                spec[2] = "model"
        return tuple(spec)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return one(node)
    return walk(caches_shapes)


def shard_bytes(shape, itemsize: int, spec: Spec, mesh) -> int:
    """Bytes of one device's shard of a leaf placed by ``spec``."""
    n = itemsize
    for i, dim in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        axes = () if entry is None else \
            ((entry,) if isinstance(entry, str) else tuple(entry))
        n *= int(dim) // _axis_size(mesh, axes)
    return n


def batch_sharding(mesh, rules=None) -> Spec:
    """The spec of a batch's dim 0."""
    rules = rules if rules is not None else default_rules(mesh)
    b = rules["batch"]
    return (b if len(b) > 1 else (b[0] if b else None),)


def data_batch_specs(mesh, batch_tree, rules=None):
    """Shard dim 0 (global batch) of every leaf in a data batch (a dict
    of arrays or tensors, or one of them).

    Leaves whose dim 0 does not divide the batch mesh axes (e.g. the
    batch=1 long-context decode cell, or scalar positions) replicate."""
    rules = rules if rules is not None else default_rules(mesh)
    bax = rules["batch"]
    size = _axis_size(mesh, bax)

    def one(leaf):
        shape = tuple(leaf.shape)
        if len(shape) == 0 or shape[0] % size or not bax:
            return ()
        return (bax if len(bax) > 1 else bax[0],) + (None,) * (len(shape) - 1)

    if isinstance(batch_tree, dict):
        return {k: data_batch_specs(mesh, v, rules)
                for k, v in batch_tree.items()}
    return one(batch_tree)


def replicated(mesh) -> Spec:
    return ()


# -- scoring-batch specs (device-parallel operator dispatch) -----------------
#
# The scoring runtime (core/runtime.py) ships flat frame batches
# ``(frames, h, w, c)`` and stacked superbatches ``(group, frames, h, w,
# c)``. Frames (and group members) are mutually independent, so either
# leading axis may shard over "data", subject to the same divisibility
# guard as every rule above: a non-dividing dim replicates (recorded,
# never fatal) and the fallback shows up in ``explain_fallbacks``.
#
# Bits: in the port both splits give the single-device bits, because the
# conv and scorer-head kernels (and their plain versions) reduce each
# output in an order that depends neither on the row count nor on the
# group. The JAX package guarantees that for the group axis only (XLA's
# gemm blocking follows the row count), so the runtime shards frames
# only when asked (``shard_frames=True``), as the JAX package does, and
# both packages place every dispatch alike.

SCORING_RULES = {"frames": ("data",), "group": ("data",)}


def frames_spec(shape, mesh, fallbacks=None) -> Spec:
    """Shard dim 0 (frames) of a flat scoring batch; replicate the rest.
    Falls back to fully replicated when the frame count does not divide
    the data axis (recorded in ``fallbacks``)."""
    axes = ("frames",) + (None,) * (len(shape) - 1)
    return spec_for_leaf(shape, axes, mesh, SCORING_RULES, fallbacks)


def superbatch_spec(shape, mesh, fallbacks=None) -> Spec:
    """Shard a stacked ``(group, frames, ...)`` superbatch on its group
    axis (whole queries stay device-local); when the group size does
    not divide the data axis the batch replicates, recorded in
    ``fallbacks``. Deliberately no frame-axis fallback, as in the JAX
    package."""
    axes = ("group",) + (None,) * (len(shape) - 1)
    return spec_for_leaf(shape, axes, mesh, SCORING_RULES, fallbacks)


def explain_fallbacks(fallbacks) -> list:
    """Summarize collected ``(axis, dim, mapped)`` fallback records: one
    JSON-friendly entry per (logical axis, mesh axes) pair, ``{"axis",
    "mesh_axes", "count", "dims"}`` with ``dims`` the sorted distinct
    offending sizes."""
    grouped: Dict[Tuple[str, Tuple[str, ...]], list] = {}
    for axis, dim, mapped in fallbacks:
        grouped.setdefault((axis, tuple(mapped)), []).append(int(dim))
    return [{"axis": axis, "mesh_axes": list(mapped),
             "count": len(dims), "dims": sorted(set(dims))}
            for (axis, mapped), dims in sorted(grouped.items())]
