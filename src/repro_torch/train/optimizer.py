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
``decay_mask``). The update runs one parameter at a time, so the float32
temporaries are one parameter's size, not the model's.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Optional

import torch

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


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every entry's square, float32, the leaves'
    sums added in the tree's order."""
    total = None
    for g in tree.values():
        s = g.float().square().sum()
        total = s if total is None else total + s
    if total is None:
        return torch.zeros((), dtype=torch.float32)
    return torch.sqrt(total)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
                  grads: Mapping[str, torch.Tensor], state: OptState,
                  decay: Optional[Mapping[str, bool]] = None):
    """One AdamW step, in place: each parameter and its m and v are
    overwritten. Returns (params, the new state, metrics ``grad_norm``
    and ``lr``). ``decay``: which parameters take the decoupled decay
    (default: those of two or more dimensions)."""
    step = state.step + 1
    gn = global_norm(grads)
    dev = gn.device
    scale = torch.clamp(cfg.clip_norm / (gn + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    # the step's scalars, float32, on the gradients' device once
    lr_d, b1c, b2c = (t.to(dev) for t in (
        lr, 1 - _f32(cfg.b1) ** step, 1 - _f32(cfg.b2) ** step))
    for n, p in params.items():
        g = grads[n].float() * scale
        m, v = state.m[n], state.v[n]
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        if (p.dim() >= 2) if decay is None else decay[n]:
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr_d * delta).to(p.dtype))
        del g, delta
    return params, OptState(step, state.m, state.v), \
        {"grad_norm": gn, "lr": lr}
