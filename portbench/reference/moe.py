"""The mixture-of-experts feed-forward network with capacity dropping.

Routing: float32 router logits h @ router, their softmax over the E
experts, each token's top-k experts by probability (ties to the lower
expert), the k weights renormalised to sum to one. Dispatch: the
(token, expert) entries in token-major order, stably grouped by expert;
an expert keeps its first C = max(8, ceil(tokens·k·capacity_factor/E))
entries and drops the rest, which then add nothing to their token.
Each kept entry adds weight x SwiGLU_e(h) to its token. Auxiliary
losses: the load-balance loss E · sum_e (top-1 share_e · mean prob_e)
and the z-loss mean(logsumexp(logits)^2).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference.transformer import mm


def route(h: torch.Tensor, router: torch.Tensor, k: int, precision: str):
    logits = mm(h, router, precision)
    probs = torch.softmax(logits, -1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w = vals[:, :k] / vals[:, :k].sum(-1, keepdim=True)
    return logits, probs, gate_w, idx[:, :k]


def capacity(tokens: int, k: int, n_experts: int, factor: float) -> int:
    return max(8, math.ceil(tokens * k * factor / n_experts))


def kept(gate_i: torch.Tensor, n_experts: int, cap: int) -> torch.Tensor:
    """(T, k) bool: the entry's place among its expert's entries, in
    token-major order, is below ``cap``."""
    e = gate_i.reshape(-1)
    order = torch.argsort(e, stable=True)
    counts = torch.bincount(e, minlength=n_experts)
    starts = counts.cumsum(0) - counts
    place = torch.empty_like(e)
    place[order] = torch.arange(e.numel(), device=e.device) - starts[e[order]]
    return (place < cap).view(gate_i.shape)


def forward(cfg, w, h: torch.Tensor, precision: str):
    """h (B, S, d) -> (y, lb_loss, z_loss)."""
    B, S, d = h.shape
    E, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    x = h.reshape(B * S, d)
    T = x.shape[0]
    logits, probs, gate_w, gate_i = route(x, w["ffn.router"], k, precision)
    keep = kept(gate_i, E, capacity(T, k, E, cfg["as_run"]["capacity_factor"]))
    y = torch.zeros_like(x)
    for e in range(E):
        tok, j = torch.nonzero((gate_i == e) & keep, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        he = F.silu(mm(xe, w["ffn.wg"][e], precision)) * \
            mm(xe, w["ffn.wu"][e], precision)
        y = y.index_add(0, tok, mm(he, w["ffn.wo"][e], precision) *
                        gate_w[tok, j][:, None])
    top1 = torch.bincount(gate_i[:, 0], minlength=E).float()
    lb = (top1 / T * probs.mean(0)).sum() * E
    z = torch.logsumexp(logits, -1).square().mean()
    return y.view(B, S, d), lb, z
