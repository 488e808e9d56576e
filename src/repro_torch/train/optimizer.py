"""AdamW + global-norm clipping + cosine schedule, in plain PyTorch.

Ported from ``repro/train/optimizer.py`` with its formulas exactly: the
gradients clipped by their global norm, ``min(1, clip / (gn + 1e-9))``;
bias corrections in float32; ``eps`` outside the square root; decoupled
weight decay; m and v float32 whatever the parameter's type. The
parameters, gradients and moments are dicts keyed by the model's
``named_parameters`` names; the global norm sums the gradients' squares
in the parameters' order. It is not ``torch.optim.AdamW``, which decays
every tensor: here only those ``decay`` marks (by default the tensors of
two or more dimensions, the JAX package's rule; a model passes its own
``decay_mask``). The update is ``kernels/adamw.adamw_update``: on the
card one hand-written launch over every parameter, which takes the
step's scalars by value (so the host does not wait for the card), with
the bits of the plain loop a parameter at a time that the CPU runs
(``kernels/ref.adamw_update``). Under a mesh
(``split``: the model's ``split_axes()``) the global norm sums each
slice's squares, then sums them over the ranks that split them, in
rank order: over the data axis (``parallel/ops.data_sum``) for the
parameters sliced over "data", then over the model axis
(``model_sum``) for those split over "model", and adds the whole
parameters' once; so every rank clips by the whole model's norm with
the same bits. The order of the float32 additions is not the one
process's, so the norm is that one's within float32 rounding (a
relative 1e-6 at the zoo's smoke sizes), not its bits. m and v are
built over the parameters a rank holds, so under FSDP they are its
slices, and the update, elementwise, runs on them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Optional

import torch

from repro_torch.kernels import adamw
from repro_torch.parallel import ops as pops

Tree = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


class OptState(NamedTuple):
    step: int                  # updates applied so far
    m: Tree
    v: Tree


def init_opt_state(params: Mapping[str, torch.Tensor]) -> OptState:
    """Zero float32 moments beside each parameter, on its device."""
    m = {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
         for n, p in params.items()}
    return OptState(0, m, {n: t.clone() for n, t in m.items()})


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate after ``step`` updates, float32 (a 0-d CPU
    tensor): linear warm-up, then a cosine down to ``min_lr_frac``."""
    step = _f32(float(step))
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps) /
                    max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi) * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def _add(a, b):
    return b if a is None else (a if b is None else a + b)


def global_norm(tree: Mapping[str, torch.Tensor],
                split: Optional[Mapping[str, tuple]] = None) -> torch.Tensor:
    """sqrt of the sum of every entry's square, float32, the leaves'
    sums added in the tree's order. ``split``: the installed mesh's axes
    that split each leaf (``Transformer.split_axes``); a split leaf's sum
    is summed over the ranks of its axes and added to the whole ones'."""
    sums: Dict[tuple, torch.Tensor] = {}
    for n, g in tree.items():
        axes = tuple(split[n]) if split is not None else ()
        sums[axes] = _add(sums.get(axes), g.float().square().sum())
    total = sums.get(())
    model = _add(sums.get(("model",)), pops.data_sum(sums[("data", "model")])
                 if ("data", "model") in sums else None)
    if model is not None:
        total = _add(total, pops.model_sum(model))
    if ("data",) in sums:
        total = _add(total, pops.data_sum(sums[("data",)]))
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
                  grads: Mapping[str, torch.Tensor], state: OptState,
                  decay: Optional[Mapping[str, bool]] = None,
                  split: Optional[Mapping[str, bool]] = None):
    """One AdamW step, in place: each parameter and its m and v are
    overwritten. Returns (params, the new state, metrics ``grad_norm``
    and ``lr``). ``decay``: which parameters take the decoupled decay
    (default: those of two or more dimensions); ``split``: the axes that
    split each over the installed mesh (``global_norm``). The update is
    ``kernels/adamw.adamw_update``: on the card one launch over every
    parameter, on the CPU the plain loop."""
    step = state.step + 1
    gn = global_norm(grads, split)
    scale = torch.clamp(cfg.clip_norm / (gn + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    names = list(params)
    ps = [params[n] for n in names]
    adamw.adamw_update(
        ps, [grads[n] for n in names], [state.m[n] for n in names],
        [state.v[n] for n in names],
        [(p.dim() >= 2) if decay is None else decay[n]
         for n, p in zip(names, ps)],
        scale, lr, 1 - _f32(cfg.b1) ** step, 1 - _f32(cfg.b2) ** step,
        cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay)
    return params, OptState(step, state.m, state.v), \
        {"grad_norm": gn, "lr": lr}
