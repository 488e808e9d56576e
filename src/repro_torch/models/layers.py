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

Under a "model" axis (``TP``: the axis's size and this rank's
coordinate) the FFN holds wg's and wu's columns and wo's rows of its
ffn slice, its input entering through ``parallel/ops.model_copy`` and
its output leaving through ``model_sum``; the embedding's rows are split
by vocab (``vocab_embed``: each rank looks up its own rows, the others
masked to zero, then ``model_sum``), and so are the LM head's logits:
``chunked_xent`` takes a log-sum-exp over the vocab shards and serving
gathers the logits in rank order (``models/transformer.py``).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.parallel import ops as pops

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


class TP(NamedTuple):
    """A module's place on a "model" axis: its size and this rank."""
    size: int
    rank: int


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
    in the compute type (``use``). ``tp``: the ffn dim is split over a
    model axis (this rank's slice of it)."""

    def __init__(self, wg: torch.Tensor, wu: torch.Tensor, wo: torch.Tensor,
                 cdt: Optional[torch.dtype] = None, trainable: bool = False,
                 tp: Optional[TP] = None):
        super().__init__()
        self.wg, self.wu, self.wo = (weight(t, trainable)
                                     for t in (wg, wu, wo))
        self.cdt = cdt
        self.tp = tp
        self.split = {"wg", "wu", "wo"} if tp is not None else set()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.tp is not None:
            x = pops.model_copy(x)
        y = swiglu(x, *(use(t, self.cdt)
                        for t in (self.wg, self.wu, self.wo)))
        return pops.model_sum(y) if self.tp is not None else y


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


def vocab_embed(tokens: torch.Tensor, table: torch.Tensor,
                tp: TP) -> torch.Tensor:
    """The embedding of a table split by vocab rows over a model axis:
    this rank's rows looked up, every other token masked to zero, summed
    over the ranks in rank order (one rank adds a token's row to zeros,
    so the sum is the row's bits)."""
    n = table.shape[0]
    local = tokens - tp.rank * n
    own = (local >= 0) & (local < n)
    rows = table[local.clamp(0, n - 1)] * own[..., None].to(table.dtype)
    return pops.model_sum(rows)


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


def _xent_chunk_split(xc: torch.Tensor, table: torch.Tensor,
                      lc: torch.Tensor, rank: int) -> torch.Tensor:
    """``_xent_chunk`` with ``table`` this rank's vocab rows: the max over
    the ranks, the exp-sum summed in rank order, the gold logit from the
    rank that owns it; no rank holds a whole (B, c, V) chunk."""
    logits = (pops.model_copy(xc) @ table.T).float()          # (B, c, V/m)
    top = pops.model_max(logits.detach().amax(dim=-1))
    lse = top + pops.model_sum(
        torch.exp(logits - top[..., None]).sum(dim=-1)).log()
    n = table.shape[0]
    local = lc.long() - rank * n
    own = (local >= 0) & (local < n)
    gold = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    gold = pops.model_sum(torch.where(own, gold, torch.zeros_like(gold)))
    return (lse - gold).sum()


def chunked_xent(x: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
                 chunk: int, tp: Optional[TP] = None) -> torch.Tensor:
    """x (B, S, d) in the compute type; table (V, d) in the compute type;
    labels (B, S) -> the mean NLL, float32
    (``repro/models/layers.py::chunked_xent``). The logits are computed
    ``chunk`` tokens at a time and each chunk is checkpointed, so the
    (B, S, V) logits are never whole, in the forward or the backward.
    ``tp``: ``table`` is this rank's vocab rows of a model axis
    (``_xent_chunk_split``)."""
    B, S, _ = x.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"the sequence {S} is not a multiple of the logit "
                         f"chunk {chunk}")
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    fn, extra = (_xent_chunk, ()) if tp is None else \
        (_xent_chunk_split, (tp.rank,))
    for i in range(0, S, chunk):
        xc, lc = x[:, i:i + chunk], labels[:, i:i + chunk]
        if torch.is_grad_enabled():
            total = total + checkpoint(fn, xc, table, lc, *extra,
                                       use_reentrant=False)
        else:
            total = total + fn(xc, table, lc, *extra)
    return total / (B * S)
