"""Meta tensors for every input of every cell.

Ported from ``repro/launch/specs.py``, whose ``ShapeDtypeStruct``s are
the abstract inputs the JAX step functions are lowered with. Here they
are tensors on PyTorch's ``meta`` device (shape and type, no storage),
which the port's step functions run on as they are (``launch/dryrun.py``),
or, with ``device`` a real one, zeros of the same shapes and types.
``batch`` overrides the cell's global batch (a data-parallel rank's
rows, or a cut).

The decode caches are the port's, one entry a layer, from
``models/transformer.py::init_caches``; ``stacked_caches`` lays them out
as the JAX package's (a tuple over pattern positions, every leaf stacked
over periods), for ``parallel/sharding.cache_shardings`` and for holding
the shapes to ``jax.eval_shape`` of the JAX ``init_caches``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs import base as cfgbase
from repro_torch.models import transformer


def _zeros(shape, dtype, device) -> torch.Tensor:
    return torch.zeros(tuple(shape), dtype=dtype, device=device)


def _prefix(cfg) -> int:
    return cfg.num_prefix_embeds if cfg.frontend == "vision" else 0


def train_specs(cfg, cell, batch: Optional[int] = None,
                device="meta") -> Dict[str, torch.Tensor]:
    """``tokens`` and ``labels`` (B, S - P) int32, and for the vision
    frontend ``prefix_embeds`` (B, P, d) in the compute type."""
    B, S, npfx = batch or cell.global_batch, cell.seq_len, _prefix(cfg)
    out = {"tokens": _zeros((B, S - npfx), torch.int32, device),
           "labels": _zeros((B, S - npfx), torch.int32, device)}
    if npfx:
        out["prefix_embeds"] = _zeros(
            (B, npfx, cfg.d_model),
            transformer.torch_dtype(cfg.compute_dtype), device)
    return out


def prefill_specs(cfg, cell, batch: Optional[int] = None,
                  device="meta") -> Dict[str, torch.Tensor]:
    """``tokens`` (B, S - P) int32, and for the vision frontend
    ``prefix_embeds`` (B, P, d) in the compute type."""
    out = train_specs(cfg, cell, batch, device)
    del out["labels"]
    return out


def decode_specs(cfg, cell, batch: Optional[int] = None, device="meta",
                 mesh=None):
    """(``tokens`` (B, 1) and ``pos`` (B,), int32; the caches of a
    ``seq_len`` context from ``init_caches``, a rank's under ``mesh``:
    its rows of the B and its part of each ring over the cache axis, as
    ``parallel/ops.serve_placement`` places them: a B of 1 whole on every
    rank, its rings split over ("data", "model"))."""
    B = batch or cell.global_batch
    inputs = {"tokens": _zeros((B, 1), torch.int32, device),
              "pos": _zeros((B,), torch.int32, device)}
    return inputs, transformer.init_caches(cfg, B, cell.seq_len, device,
                                           mesh=mesh)


def input_specs(arch: str, shape_name: str):
    """Public entry: (arch, shape) -> meta inputs for its step."""
    cfg = cfgbase.get_config(arch)
    cell = cfgbase.SHAPES[shape_name]
    if cell.kind == "train":
        return train_specs(cfg, cell)
    if cell.kind == "prefill":
        return prefill_specs(cfg, cell)
    return decode_specs(cfg, cell)


def stacked_caches(cfg, caches):
    """The port's caches (a list, one a layer) in the JAX package's
    layout: a tuple over pattern positions, each leaf a meta tensor with
    the periods' axis in front."""
    period = len(cfg.pattern)

    def stack(leaf):
        return torch.empty((cfg.num_periods,) + tuple(leaf.shape),
                           dtype=leaf.dtype, device="meta")

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (tuple, list)):
            return type(node)(walk(v) for v in node)
        return stack(node)
    return tuple(walk(caches[j]) for j in range(period))
