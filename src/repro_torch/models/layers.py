"""Foundational layers of the LM zoo: RMSNorm, the SwiGLU FFN, the
recurrent mixers' module, the embedding and the rotary position
embedding.

Ported from ``repro/models/layers.py``. The JAX package keeps float32
weights and casts them to the compute type on every call; the port casts
them once, when the model is built (``models/transformer.py``), which
rounds the same way. Norm scales stay float32, as the JAX norms read
them. ``Annot``, ``shape_only`` and ``chunked_xent`` belong to training
and the dry-run and are not ported yet.
"""
from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.kernels import ops


def frozen(t: torch.Tensor) -> nn.Parameter:
    """A weight of a model that serves and does not train."""
    return nn.Parameter(t, requires_grad=False)


class RMSNorm(nn.Module):
    """``x * rsqrt(mean(x^2) + eps) * scale`` over the last dim, float32
    inside; through ``ops.rmsnorm`` (the CUDA kernel on the card)."""

    def __init__(self, scale: torch.Tensor, eps: float):
        super().__init__()
        self.scale = frozen(scale.float())
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return ops.rmsnorm(x, self.scale, self.eps)


class FFN(nn.Module):
    """Dense SwiGLU: ``(silu(x @ wg) * (x @ wu)) @ wo``, with the weights
    already in the compute type."""

    def __init__(self, wg: torch.Tensor, wu: torch.Tensor, wo: torch.Tensor):
        super().__init__()
        self.wg, self.wu, self.wo = frozen(wg), frozen(wu), frozen(wo)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return swiglu(x, self.wg, self.wu, self.wo)


class Mixer(nn.Module):
    """A recurrent mixer of a served block (Mamba, mLSTM or sLSTM): its
    frozen weights, and the module functions ``forward(x, w, **kw)`` and
    ``decode(x, w, cache, **kw)`` that read them with ``kw`` (``d_state``
    or ``n_heads``)."""

    def __init__(self, w, forward, decode, **kw):
        super().__init__()
        self.w = nn.ParameterDict({n: frozen(t) for n, t in w.items()})
        self.fns, self.kw = (forward, decode), kw

    def forward(self, x: torch.Tensor):
        return self.fns[0](x, self.w, **self.kw)

    def decode(self, x: torch.Tensor, cache):
        return self.fns[1](x, self.w, cache, **self.kw)


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
