"""Mixture-of-Experts FFN with sort-based, static-shape dispatch.

Ported from ``repro/models/moe.py``, step for step: route each token to
its top-k experts, stable-sort the (token, expert) entries by expert,
place them in a per-expert capacity buffer (E, C, d), run the grouped
SwiGLU through ``ops.moe_gmm`` (the CUDA kernel on the card), and add
each expert's output back into its token, scaled by the router weight.
Every shape follows from the token count, so nothing waits for the
card before the sampler's copy.

The JAX package pads the experts to its 16-way expert-parallel axis
(``padded_experts``) and pins the dead experts' router logits to -1e30,
so their probabilities are exactly 0 and they are never routed to. A
model of one process keeps only the real experts (``real_experts``),
which changes no output and no aux loss.

Under a "model" axis (``tp``) a rank holds its slice of the padded
experts' wg, wu and wo (experts ``r·Ep/m … (r+1)·Ep/m - 1``, the dead
ones never routed to) and every rank holds the router over the real
experts. The batch is not split over "model", so the router, the routes
and the capacity rows are the same on every rank and no all-to-all is
needed: each rank fills and multiplies only its own experts' capacity
rows, adds each token's contributions from its own experts in ascending
expert order, adds its slice of the shared experts (split like the
FFN), and the ranks' partial outputs are summed in rank order
(``parallel/ops.model_sum``): within rounding of one process, not bit
for bit (the one-process sum adds a token's k contributions in one
chain). The aux losses come from the replicated router and are not
summed over "model". The token rows and the routing weights enter the
rank's experts through ``model_copy``, so the router's gradient is the
whole one on every rank.

Tokens are routed within ``G`` groups, as in the JAX package: ``G`` is
the installed mesh's data-parallel shard count
(``parallel/ops.data_group_count``; 1 without a mesh), or 1 where the
tokens do not divide into groups of at least ``n_experts``. Each group
sorts its own (token, expert) entries and has its own capacity; the G
groups' capacity rows are stacked on the capacity axis, ``(E, G·cap,
d)``, so each expert product is still one ``moe_gmm`` launch. Under a
mesh whose data axis spans processes (data-parallel training), a rank
holds the groups of its own rows (one a rank), and the aux losses'
router statistics are summed over the ranks (``parallel/ops.
gather_sum``), so every rank computes the global losses.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.parallel import ops as pops


def padded_experts(e: int, ep: int = 16) -> int:
    """The JAX package's expert count: e rounded up to a multiple of ep
    (only if not already divisible)."""
    return -(-e // ep) * ep if e % ep else e


def real_experts(p: Mapping[str, torch.Tensor],
                 n_experts: int) -> Dict[str, torch.Tensor]:
    """The first ``n_experts`` experts and router columns of the JAX
    package's padded MoE weights (router (d, ep), wg and wu (ep, d, f),
    wo (ep, f, d)); raises unless ep is ``padded_experts(n_experts)``.
    Other entries (``shared``) pass through."""
    ep = p["router"].shape[-1]
    if ep != padded_experts(n_experts) or any(
            p[n].shape[0] != ep for n in ("wg", "wu", "wo")):
        raise ValueError(f"the MoE weights hold {ep} experts; the JAX "
                         f"package pads {n_experts} to "
                         f"{padded_experts(n_experts)}")
    out = dict(p)
    if ep != n_experts:          # copies, so the padded draws can be freed
        out["router"] = p["router"][:, :n_experts].clone()
        for n in ("wg", "wu", "wo"):
            out[n] = p[n][:n_experts].clone()
    return out


def route(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """x (T, d) and router (d, E) in the compute type -> (logits, probs,
    gate_w, gate_i): float32 logits and softmax, the top-k weights
    renormalised to sum to 1, and their experts (T, k). Ties go to the
    lower expert, as ``jax.lax.top_k`` breaks them: a stable descending
    sort keeps equal probabilities in expert order."""
    logits = (x @ router).float()
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_w, gate_i = vals[:, :top_k], idx[:, :top_k]
    gate_w = gate_w / gate_w.sum(-1, keepdim=True).clamp_min(1e-9)
    return logits, probs, gate_w, gate_i


def aux_losses(logits: torch.Tensor, probs: torch.Tensor,
               gate_i: torch.Tensor, n_experts: int):
    """Switch-style load-balance loss and router z-loss, float32, from
    ``route``'s logits, probabilities and experts. Under a mesh over
    processes the expert densities, the top-1 counts and the z-loss are
    summed over the ranks first (one gather), so the losses are those of
    the global batch on every rank."""
    T, E = probs.shape
    density = probs.mean(dim=0)
    top1 = torch.zeros(E, dtype=torch.float32, device=probs.device)
    top1.index_add_(0, gate_i[:, 0],                 # counts: exact sums
                    torch.ones(T, dtype=torch.float32, device=probs.device))
    z_loss = torch.logsumexp(logits, dim=-1).square().mean()
    n = pops.data_ranks()
    if n > 1:
        stats = pops.gather_sum(torch.cat([density, top1, z_loss[None]]))
        density, top1, z_loss = stats[:E] / n, stats[E:2 * E], stats[-1] / n
        T = T * n
    lb_loss = (top1 / T * density).sum() * n_experts
    return lb_loss, z_loss


def moe_forward(x: torch.Tensor, params: Mapping, *, n_experts: int,
                top_k: int, capacity_factor: float,
                tp: Optional[layers.TP] = None, shared_split: bool = False
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """x (B, S, d) in the compute type -> (y (B, S, d), (lb_loss,
    z_loss)), as ``repro/models/moe.py::moe_forward``. ``params``:
    ``router`` (d, E), ``wg``, ``wu`` (E, d, f), ``wo`` (E, f, d), the
    real experts only, in the compute type; optional ``shared`` with a
    dense SwiGLU's ``wg``, ``wu``, ``wo``."""
    y, routing = moe_ffn(x, params, n_experts=n_experts, top_k=top_k,
                         capacity_factor=capacity_factor, tp=tp,
                         shared_split=shared_split)
    return y, aux_losses(*routing, n_experts)


def moe_ffn(x: torch.Tensor, params: Mapping, *, n_experts: int,
            top_k: int, capacity_factor: float,
            tp: Optional[layers.TP] = None, shared_split: bool = False):
    """``moe_forward``'s output and its routing (logits, probs, gate_i)
    instead of the aux losses, which serving drops (the JAX package's
    jitted decode never computes them; eager PyTorch would). ``tp``:
    ``params``' experts are this rank's slice of a model axis (the
    module's docstring), and with ``shared_split`` the shared experts'
    ffn dim too."""
    B, S, d = x.shape
    router = params["router"]
    E = router.shape[-1]
    if E != n_experts:
        raise ValueError(f"the router has {E} experts, the config "
                         f"{n_experts}: load the real experts only")
    cdt = x.dtype
    T, k = B * S, top_k
    xf = x.reshape(T, d)
    # the dispatch, routing to the filled capacity rows, is a span
    # ``moe.dispatch`` with its counts: rows routed, kept, and in the buffer
    with spans.span("moe.dispatch") as sp:
        logits, probs, gate_w, gate_i = route(xf, router, k)

        # ---- grouped sort-based dispatch into per-expert capacity rows
        G = pops.local_group_count()
        if torch.is_grad_enabled() and pops.data_ranks() > 1 and \
                T // G < n_experts:
            # training only: a served rank routes its rows as one process
            # would (a decode tick's few rows form one group)
            raise ValueError(f"a rank routes {T // G} tokens a group, fewer "
                             f"than the {n_experts} experts; the global "
                             "program would route them in one group")
        if T % G or T // G < max(n_experts, 1):
            G = 1                                  # tiny decode batches
        Tg = T // G
        dev = x.device
        e_flat = gate_i.reshape(T * k)                         # token-major
        # group-major, then expert: each group's entries sorted by expert in
        # token order, as the JAX package's per-group stable sort (one group:
        # the expert alone, and no extra operations on the serving path)
        key = e_flat if G == 1 else torch.div(
            torch.arange(T * k, device=dev), Tg * k,
            rounding_mode="floor") * E + e_flat
        order = torch.argsort(key, stable=True)
        sk = key[order]
        se = sk if G == 1 else sk % E
        st = torch.div(order, k, rounding_mode="floor")        # tokens
        sw = gate_w.reshape(T * k)[order]
        counts = torch.zeros(G * E, dtype=torch.long, device=dev).index_add_(
            0, key, torch.ones_like(key))
        starts = counts.cumsum(0) - counts
        pos = torch.arange(T * k, device=dev) - starts[sk]
        cap = max(8, int(-(-Tg * k * capacity_factor // max(n_experts, 1))))
        keep = pos < cap
        # expert e's capacity rows are buf[e * G·cap: (e + 1) * G·cap], group
        # g's cap of them at g * cap; dropped entries go to the trash row
        # E * G·cap, which is cut off
        rows_e = G * cap
        base = se * rows_e if G == 1 else \
            se * rows_e + torch.div(sk, E, rounding_mode="floor") * cap
        slot = torch.where(keep, base + pos, E * rows_e)
        xs, row = xf, base + pos.clamp_max(cap - 1)
        if tp is not None:
            # this rank's experts only: the other experts' entries go to the
            # trash row and add zero
            E = params["wg"].shape[0]
            lo = tp.rank * E * rows_e
            keep = keep & (base >= lo) & (base < lo + E * rows_e)
            slot = torch.where(keep, base - lo + pos, E * rows_e)
            row = torch.where(keep, slot, 0)
            xs, sw = pops.model_copy(xf), pops.model_copy(sw)
        buf = torch.zeros(E * rows_e + 1, d, dtype=cdt, device=dev)
        buf[slot] = xs[st] * keep[:, None].to(cdt)
        buf = buf[:E * rows_e].view(E, rows_e, d)
        if sp:
            sp.count(routed=T * k, kept=keep.sum(), rows=E * rows_e)

    h = F.silu(ops.moe_gmm(buf, params["wg"])) * ops.moe_gmm(buf,
                                                             params["wu"])
    out_buf = ops.moe_gmm(h, params["wo"]).view(E * rows_e, d)

    with spans.span("moe.combine"):
        gathered = out_buf[row]
        contrib = gathered * (sw * keep).to(cdt)[:, None]  # sorted order
        # each token's k contributions, added in the compute type in
        # sorted order (ascending expert), as the JAX package's
        # scatter-add runs them; a fixed order, where index_add_ on the
        # card would not be
        inv = torch.empty_like(order)
        inv[order] = torch.arange(T * k, device=dev)
        rows = torch.sort(inv.view(T, k), dim=1).values
        y = contrib[rows[:, 0]]
        for j in range(1, k):
            y = y + contrib[rows[:, j]]

    shared = params.get("shared")
    split = shared is not None and tp is not None and shared_split
    if split:                     # its partial sums join the experts'
        y = y + layers.swiglu(xs, shared["wg"], shared["wu"], shared["wo"])
    if tp is not None:
        y = pops.model_sum(y)
    if shared is not None and not split:
        y = y + layers.swiglu(xf, shared["wg"], shared["wu"], shared["wo"])
    y = y.reshape(B, S, d)
    spans.around_backward("moe.bwd", y, x, dev)
    return y, (logits, probs, gate_i)


class MoE(nn.Module):
    """The MoE FFN of a block, the real experts only (``real_experts``):
    weights in the compute type when serving, or held in the parameter
    type and cast to ``cdt`` at use when training. ``tp``: wg, wu and wo
    are this rank's slice of the padded experts of a model axis; the
    shared experts' ffn dim is split where ``shared_tp`` is given."""

    def __init__(self, w: Mapping, *, n_experts: int, top_k: int,
                 capacity_factor: float, cdt: Optional[torch.dtype] = None,
                 trainable: bool = False, tp: Optional[layers.TP] = None,
                 shared_tp: Optional[layers.TP] = None):
        super().__init__()
        self.n_experts, self.top_k = n_experts, top_k
        self.capacity_factor = capacity_factor
        self.cdt = cdt
        self.tp = tp
        self.router = layers.weight(w["router"], trainable)
        self.wg, self.wu, self.wo = (layers.weight(w[n], trainable)
                                     for n in ("wg", "wu", "wo"))
        self.split = {"wg", "wu", "wo"} if tp is not None else set()
        # the shared experts' partial sums join the experts' in one
        # model_sum, so their FFN runs no collective of its own
        self.shared = layers.FFN(**w["shared"], cdt=cdt,
                                 trainable=trainable) \
            if "shared" in w else None
        if self.shared is not None and shared_tp is not None:
            self.shared.split = {"wg", "wu", "wo"}

    def params(self) -> Dict:
        c = self.cdt
        p = {n: layers.use(getattr(self, n), c)
             for n in ("router", "wg", "wu", "wo")}
        if self.shared is not None:
            p["shared"] = {n: layers.use(getattr(self.shared, n), c)
                           for n in ("wg", "wu", "wo")}
        return p

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return moe_ffn(x, self.params(), n_experts=self.n_experts,
                       top_k=self.top_k, capacity_factor=self.capacity_factor,
                       tp=self.tp, shared_split=self._shared_split())[0]

    def forward_aux(self, x: torch.Tensor):
        """Training's forward: (y, (lb_loss, z_loss))."""
        return moe_forward(x, self.params(), n_experts=self.n_experts,
                           top_k=self.top_k,
                           capacity_factor=self.capacity_factor, tp=self.tp,
                           shared_split=self._shared_split())

    def _shared_split(self) -> bool:
        return self.shared is not None and bool(self.shared.split)
