"""Foundational layers of the LM zoo: RMSNorm, the SwiGLU FFN, the
recurrent mixers' module, the embedding, the rotary position embedding
and the chunked cross-entropy of training.

Ported from ``repro/models/layers.py``. The JAX package keeps float32
weights and casts them to the compute type on every call. A served
model (``models/transformer.py``) casts them once, when it is built,
which rounds the same way, and its modules read them as they are
(``cdt`` None). A model built for training holds them in the config's
parameter type as trainable Parameters, and its modules cast each to
the compute type ``cdt`` where they use it (``use``), as the JAX layers
do. Norm scales stay float32, as the JAX norms read them, and so do the
mixer weights the JAX package reads in float32 (``FLOAT32_WEIGHTS``).

The JAX package builds its parameters as ``Annot(value, axes)`` pairs
and, under ``shape_only``, as shapes with no values, which
``split_annotated`` splits into a parameter tree and its logical-axes
tree for its sharding rules and its dry run. The port's counterpart is
``ParamSpec``: one leaf of that tree (its path, its JAX shape, its type
and its logical axes), listed from the config alone by
``models/transformer.py::param_specs``; no value is drawn or held.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops

# mixer weights the JAX package casts to float32 where it reads them
FLOAT32_WEIGHTS = ("A_log", "gn_scale", "r")


class ParamSpec(NamedTuple):
    """One leaf of the JAX package's parameter tree: ``path`` (the keys
    from the root, e.g. ``("blocks", 0, "mixer", "wq")``), ``shape`` (the
    JAX shape: stacked over periods, query heads and experts padded),
    ``dtype`` and ``axes`` (its logical axis names, None unsharded)."""
    path: Tuple[object, ...]
    shape: Tuple[int, ...]
    dtype: torch.dtype
    axes: Tuple[Optional[str], ...]

    @property
    def numel(self) -> int:
        return math.prod(self.shape)


def weight(t: torch.Tensor, trainable: bool) -> nn.Parameter:
    """A weight: trainable, or frozen (a model that serves)."""
    return nn.Parameter(t, requires_grad=trainable)


def use(t: torch.Tensor, cdt: Optional[torch.dtype]) -> torch.Tensor:
    """A weight as a module reads it: cast to the compute type ``cdt``
    (training), or as held (``cdt`` None: a served model's weights are
    already in it)."""
    return t if cdt is None or t.dtype == cdt else t.to(cdt)


class RMSNorm(nn.Module):
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last dim, float32
    inside; through ``ops.rmsnorm`` (the CUDA kernel on the card, and
    its backward kernel under autograd)."""

    def __init__(self, scale: torch.Tensor, eps: float,
                 trainable: bool = False):
        super().__init__()
        self.scale = weight(scale.float(), trainable)
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.rmsnorm(x, self.scale, self.eps)


class FFN(nn.Module):
    """Dense SwiGLU: ``(silu(x @ wg) * (x @ wu)) @ wo``, the weights read
    in the compute type (``use``)."""

    def __init__(self, wg: torch.Tensor, wu: torch.Tensor, wo: torch.Tensor,
                 cdt: Optional[torch.dtype] = None, trainable: bool = False):
        super().__init__()
        self.wg, self.wu, self.wo = (weight(t, trainable)
                                     for t in (wg, wu, wo))
        self.cdt = cdt

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(x, *(use(t, self.cdt)
                           for t in (self.wg, self.wu, self.wo)))


class Mixer(nn.Module):
    """A recurrent mixer of a block (Mamba, mLSTM or sLSTM): its weights,
    and the module functions ``forward(x, w, **kw)`` and ``decode(x, w,
    cache, **kw)`` that read them with ``kw`` (``d_state`` or
    ``n_heads``). With a compute type ``cdt`` (training) each weight but
    ``FLOAT32_WEIGHTS`` is cast to it at use."""

    def __init__(self, w, forward, decode, cdt: Optional[torch.dtype] = None,
                 trainable: bool = False, **kw):
        super().__init__()
        self.w = nn.ParameterDict({n: weight(t, trainable)
                                   for n, t in w.items()})
        self.fns, self.kw, self.cdt = (forward, decode), kw, cdt

    def _weights(self):
        if self.cdt is None:
            return self.w
        return {n: t if n in FLOAT32_WEIGHTS else use(t, self.cdt)
                for n, t in self.w.items()}

    def forward(self, x: torch.Tensor):
        return self.fns[0](x, self._weights(), **self.kw)

    def decode(self, x: torch.Tensor, cache):
        return self.fns[1](x, self._weights(), cache, **self.kw)


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
           wo: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ wg) * (x @ wu)) @ wo


def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed_logits(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """x (..., d) -> logits (..., V)."""
    return x @ table.T


def rope_freqs(head_dim: int, theta: float,
               device: torch.device = None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (B, S, H, D), positions (B, S) or (S,): rotation in split-halves
    layout with float32 angles, cast back to x's type."""
    inv = rope_freqs(x.shape[-1], theta, x.device)            # (D/2,)
    ang = positions.float()[..., None] * inv                  # (.., S, D/2)
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def _xent_chunk(xc: torch.Tensor, table: torch.Tensor,
                lc: torch.Tensor) -> torch.Tensor:
    logits = (xc @ table.T).float()                           # (B, c, V)
    lse = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lc[..., None].long())[..., 0]
    return (lse - gold).sum()


def chunked_xent(x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
                 chunk: int) -> torch.Tensor:
    """x (B, S, d) in the compute type; table (V, d) in the compute type;
    labels (B, S) -> the mean NLL, float32
    (``repro/models/layers.py::chunked_xent``). The logits are computed
    ``chunk`` tokens at a time and each chunk is checkpointed, so the
    (B, S, V) logits are never whole, in the forward or the backward."""
    B, S, _ = x.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"the sequence {S} is not a multiple of the logit "
                         f"chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, S, chunk):
        xc, lc = x[:, i:i + chunk], labels[:, i:i + chunk]
        if torch.is_grad_enabled():
            total = total + checkpoint(_xent_chunk, xc, table, lc,
                                       use_reentrant=False)
        else:
            total = total + _xent_chunk(xc, table, lc)
    return total / (B * S)
