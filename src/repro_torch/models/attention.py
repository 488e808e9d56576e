"""GQA attention block: prefill through the flash-attention kernel,
decode through the decode-attention kernel over a ring cache.

Ported from ``repro/models/attention.py``. Layout: flat query heads
(B, S, H, D) and compact kv heads (B, S, KV, D); query head h reads kv
head h // (H / KV), and the kernels take the compact kv as it is.

The JAX package pads the query heads up to a multiple of its 16-way
tensor-parallel axis (``padded_heads``) and masks the padded heads so
that they add exactly zero. A model of one process keeps only the real
heads: ``models/convert.py`` drops the padded heads' weights, which
changes no output.

Under a "model" axis of m ranks (``tp``, ``models/transformer.py``) a
rank holds its slice of the padded heads: wq's columns and wo's rows of
heads ``r·Hp/m … (r+1)·Hp/m - 1``. The dead heads among them compute
exactly zero, as in the JAX package: a trained model multiplies wq and
wo by the head mask at every use (``_head_mask``), so the dead weights
take exactly zero gradient; a served one has them zeroed once. The kv
heads are split too where each rank's real heads read only its own kv
heads (``kv_split``: m divides KV and no head is padded); otherwise
every rank projects them all (replicated) and gives each local head its
kv head (``kv_gather_index``; a dead head reads kv head 0). The input
enters the rank's heads through ``parallel/ops.model_copy`` and the
output projection's partial sums leave through ``model_sum``.

The decode cache is split by sequence (the JAX ``cache_shardings``)
over the cache axis of the installed mesh (``parallel/ops.cache_size``,
``cache_rank``): the model axis's m ranks, or at a batch of 1 on a data
axis of d processes all d·m ranks, data major. Rank i of n holds ring
rows ``i·S/n … (i+1)·S/n - 1`` of every kv head. A tick gathers the
queries over the heads (and the new k, v where the kv heads are split;
nothing without a model axis), the rank holding ring row ``pos % S``
writes it, every rank attends over its own rows for all heads
(``ops.decode_attention`` with the slice's row offset and its
log-sum-exp), and the n partial outputs are gathered over the cache
axis and merged in its order (``merge_partials``), so every rank holds
the same bits; each rank keeps its own heads for wo.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from repro_torch.kernels import ops
from repro_torch.models import layers
from repro_torch.parallel import ops as pops


def padded_heads(n_heads: int, tp: int = 16) -> int:
    """H rounded up to a multiple of tp (only if not already divisible):
    the JAX package's query-head count."""
    return -(-n_heads // tp) * tp if n_heads % tp else n_heads


def kv_gather_index(n_heads: int, n_kv: int, h_pad: int) -> torch.Tensor:
    """The JAX package's q -> kv map: real head h reads kv head
    h // (H / KV), a padded head kv head 0. (h_pad,) int64."""
    idx = torch.zeros(h_pad, dtype=torch.long)
    idx[:n_heads] = torch.arange(n_heads) // (n_heads // n_kv)
    return idx


def kv_split(n_heads: int, n_kv: int, m: int) -> bool:
    """Are the kv heads split over a model axis of m ranks? Where m
    divides KV and no query head is padded, so that every rank's heads
    read only its own kv heads, in the kernels' grouping."""
    return m > 1 and n_kv % m == 0 and padded_heads(n_heads) == n_heads


def ring_part(k: torch.Tensor, S: int, rows: slice) -> torch.Tensor:
    """Rows ``rows`` of the ring of S rows holding k (B, L, ...)'s
    positions 0 .. L-1, row p % S holding position p, built without the
    rest of the ring (a rank's part of a long context's ring): row r
    holds position L - 1 - ((L - 1 - r) mod S) once L > S, else position
    r below L and zeros past it; ``k``'s own rows when L == S (``k``
    itself for the whole ring)."""
    L, a, b = k.shape[1], rows.start, rows.stop
    if L == S:
        return k[:, a:b].contiguous()
    if L > S:
        r = torch.arange(a, b, device=k.device)
        return k[:, L - 1 - (L - 1 - r) % S]
    out = k.new_zeros((k.shape[0], b - a) + tuple(k.shape[2:]))
    n = max(min(b, L) - a, 0)
    out[:, :n] = k[:, a:a + n]
    return out


def merge_partials(parts) -> torch.Tensor:
    """The ranks' (out (B, H, D) float32, lse (B, H)) partial attention
    outputs over disjoint rows, merged in rank order: each weighted by
    exp(lse - max lse), the weighted outputs and the weights summed rank
    0 first, the one divided by the other. Float32. The max and the
    weights are taken for every part at once and each sum adds one
    tensor a part, so n parts take n + 8 operations, not 6 n."""
    lse = torch.stack([t for _, t in parts])                  # (n, B, H)
    w = torch.exp(lse - lse.amax(dim=0))[..., None]
    terms = torch.cat([torch.stack([o for o, _ in parts]) * w, w], dim=-1)
    total = terms[0]
    for t in terms[1:]:
        total = total + t
    return total[..., :-1] / total[..., -1:]


class Attention(nn.Module):
    """Weights wq (d, H, D), wk and wv (d, KV, D), wo (H, D, d), in the
    JAX package's order, held flat; in the compute type when serving, or
    held in the parameter type and cast to ``cdt`` at use when training.
    ``tp``: this rank's (size, rank) of a "model" axis (None for one
    process), with wq and wo the rank's slice of the padded heads and
    wk, wv its kv heads' (``kv_split``) or all of them."""

    def __init__(self, wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
                 wo: torch.Tensor, *, n_heads: int, n_kv: int,
                 window: Optional[int], rope_theta: float,
                 cdt: Optional[torch.dtype] = None, trainable: bool = False,
                 tp: Optional[layers.TP] = None):
        super().__init__()
        self.n_heads, self.n_kv = wq.shape[1], wk.shape[1]   # this rank's
        self.head_dim = wq.shape[-1]
        self.window = window
        self.rope_theta = rope_theta
        self.cdt = cdt
        self.tp = tp if tp is not None and tp.size > 1 else None
        d = wq.shape[0]
        self.real_heads = n_heads
        self.register_buffer("col_mask", None, persistent=False)
        self.register_buffer("kv_index", None, persistent=False)
        self.kv_slice = None
        if self.tp is not None:
            self.h0 = self.tp.rank * self.n_heads    # first global head
            live = torch.arange(self.h0, self.h0 + self.n_heads) < n_heads
            if padded_heads(n_heads) != n_heads:
                # the JAX head mask, on every rank (the same operations)
                mask = live.to(device=wq.device, dtype=wq.dtype)
                if trainable:
                    self.col_mask = mask.repeat_interleave(
                        self.head_dim).to(cdt or wq.dtype)
                else:
                    wq = wq * mask[:, None]
                    wo = wo * mask[:, None, None]
            self.split = {"wq", "wo"}
            if self.n_kv != n_kv:
                self.split |= {"wk", "wv"}
            else:
                self._kv_map(n_heads, n_kv, wk.device)
        self.wq = layers.weight(wq.reshape(d, -1), trainable)
        self.wk = layers.weight(wk.reshape(d, -1), trainable)
        self.wv = layers.weight(wv.reshape(d, -1), trainable)
        self.wo = layers.weight(wo.reshape(-1, wo.shape[-1]), trainable)

    def _kv_map(self, n_heads: int, n_kv: int, device) -> None:
        """The rank's heads' kv heads when every rank holds all of them: a
        compact slice where they are a whole group of the kernels' kind,
        else the JAX gather index."""
        idx = kv_gather_index(n_heads, n_kv, padded_heads(n_heads))[
            self.h0:self.h0 + self.n_heads]
        k0, k1 = int(idx.min()), int(idx.max()) + 1
        g = self.n_heads // (k1 - k0)
        if self.h0 + self.n_heads <= n_heads and \
                self.n_heads % (k1 - k0) == 0 and torch.equal(
                    idx, k0 + torch.arange(self.n_heads) // g):
            self.kv_slice = (k0, k1)
        else:
            self.kv_index = idx.to(device)

    def _w(self, name: str) -> torch.Tensor:
        t = layers.use(getattr(self, name), self.cdt)
        if self.col_mask is None or name not in ("wq", "wo"):
            return t
        mask = self.col_mask
        return t * mask if name == "wq" else t * mask[:, None]

    def _proj_qkv(self, x: torch.Tensor):
        """x (B, S, d) -> q (B, S, H, D), k and v (B, S, KV, D) (this
        rank's heads); under a model axis x enters the rank's heads
        through ``model_copy``, and replicated kv heads are projected
        from x itself."""
        B, S, _ = x.shape
        xs = pops.model_copy(x) if self.tp is not None else x
        xk = xs if self.tp is None or "wk" in self.split else x
        q = (xs @ self._w("wq")).view(B, S, self.n_heads, self.head_dim)
        k = (xk @ self._w("wk")).view(B, S, self.n_kv, self.head_dim)
        v = (xk @ self._w("wv")).view(B, S, self.n_kv, self.head_dim)
        return q, k, v

    def _kv_for_heads(self, k: torch.Tensor, v: torch.Tensor):
        """The kv heads the rank's query heads read, in the kernels'
        compact grouping; replicated kv heads enter the rank's heads
        through ``model_copy``."""
        if self.tp is None or "wk" in self.split:
            return k, v
        k, v = pops.model_copy(k), pops.model_copy(v)
        if self.kv_slice is not None:
            k0, k1 = self.kv_slice          # contiguous, as the kernels take
            return k[:, :, k0:k1].contiguous(), v[:, :, k0:k1].contiguous()
        return k[:, :, self.kv_index], v[:, :, self.kv_index]

    def _proj_out(self, o: torch.Tensor) -> torch.Tensor:
        B, S = o.shape[:2]
        out = o.reshape(B, S, -1) @ self._w("wo")
        return pops.model_sum(out) if self.tp is not None else out

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Prefill (``attn_forward``). x (B, S, d) -> (out, (k, v)) with
        the compact roped k, v for the cache (this rank's kv heads)."""
        q, k, v = self._proj_qkv(x)
        q = layers.apply_rope(q, positions, self.rope_theta)
        k = layers.apply_rope(k, positions, self.rope_theta)
        kq, vq = self._kv_for_heads(k, v)
        o = ops.attention(q, kq, vq, causal=True, window=self.window)
        return self._proj_out(o), (k, v)

    def cache(self, k: torch.Tensor, v: torch.Tensor,
              cache_len: Optional[int]) -> Dict[str, torch.Tensor]:
        """The decode cache of a prefill's k, v (B, L, KV, D): rings of
        ``cache_len`` rows (the window's for a window layer; L when None),
        row p % S holding position p. Over a cache axis of n ranks
        (``parallel/ops.cache_size``): every kv head (gathered where they
        are split over "model"), this rank's S/n rows."""
        S = k.shape[1] if cache_len is None else cache_len
        if self.window is not None:
            S = min(S, self.window)
        if self.tp is not None and "wk" in self.split:
            kv = pops.model_gather(torch.cat([k, v], dim=2), dim=2)
            kv = kv.view(kv.shape[:2] + (self.tp.size, 2, self.n_kv, -1))
            k = kv[:, :, :, 0].flatten(2, 3)
            v = kv[:, :, :, 1].flatten(2, 3)
        rows = ring_rows(S, (pops.cache_size(), pops.cache_rank()))
        return {"k": ring_part(k, S, rows), "v": ring_part(v, S, rows)}

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               pos: torch.Tensor) -> torch.Tensor:
        """Decode one token per row (``attn_decode``). x (B, 1, d); cache
        k, v (B, S, KV, D) ring buffers, written in place: the new roped
        k, v go to ring row ``pos % S``; pos (B,) int32 absolute
        positions, on x's device. Over a cache axis of n ranks the cache
        is this rank's S/n rows of rings of S (``ring_rows``)."""
        if pops.cache_size() > 1:
            return self._decode_split(x, cache, pos)
        B = x.shape[0]
        S = cache["k"].shape[1]
        q, k, v = self._proj_qkv(x)
        p = pos[:, None]
        q = layers.apply_rope(q, p, self.rope_theta)
        k = layers.apply_rope(k, p, self.rope_theta)
        rows = torch.arange(B, device=x.device)
        slot = (pos % S).long()
        cache["k"][rows, slot] = k[:, 0]
        cache["v"][rows, slot] = v[:, 0]
        o = ops.decode_attention(q[:, 0], cache["k"], cache["v"], pos)
        return self._proj_out(o[:, None])

    def _decode_split(self, x, cache, pos):
        """The decode tick of a rank of the cache axis (the module's
        docstring)."""
        B = x.shape[0]
        n, i = pops.cache_size(), pops.cache_rank()
        Sl = cache["k"].shape[1]
        q, k, v = self._proj_qkv(x)
        p = pos[:, None]
        q = layers.apply_rope(q, p, self.rope_theta)[:, 0]     # (B, Hl, D)
        k = layers.apply_rope(k, p, self.rope_theta)[:, 0]     # (B, KVl, D)
        v = v[:, 0]
        # without a model axis the rank holds every head already
        if self.tp is not None and "wk" in self.split:
            # one gather of every rank's queries and new k, v
            qkv = pops.model_parts(torch.cat([q, k, v], dim=1))
            q = torch.cat([t[:, :self.n_heads] for t in qkv], dim=1)
            k = torch.cat([t[:, self.n_heads:self.n_heads + self.n_kv]
                           for t in qkv], dim=1)
            v = torch.cat([t[:, self.n_heads + self.n_kv:] for t in qkv],
                          dim=1)
        elif self.tp is not None:
            q = torch.cat(pops.model_parts(q), dim=1)
        # only the rank holding ring row pos % S writes it (every rank
        # runs the same operations)
        rows = torch.arange(B, device=x.device)
        local = (pos % (Sl * n)).long() - i * Sl
        own = ((local >= 0) & (local < Sl))[:, None, None]
        at = local.clamp(0, Sl - 1)
        cache["k"][rows, at] = torch.where(own, k, cache["k"][rows, at])
        cache["v"][rows, at] = torch.where(own, v, cache["v"][rows, at])
        o, lse = ops.decode_attention(
            q[:, :self.real_heads].contiguous(), cache["k"], cache["v"],
            pos, row0=i * Sl, rows=Sl * n, lse=True)
        # one merge of all n parts in the axis's order: the same bits on
        # every rank
        parts = pops.cache_parts(torch.cat([o.float(), lse[..., None]],
                                           dim=-1))
        o = merge_partials([(t[..., :-1], t[..., -1]) for t in parts])
        if self.tp is not None:
            hp = self.n_heads * self.tp.size
            if hp > self.real_heads:                  # the dead heads' zeros
                o = torch.cat([o, o.new_zeros(
                    (B, hp - self.real_heads, self.head_dim))], dim=1)
            o = o[:, self.h0:self.h0 + self.n_heads]            # own heads
        return self._proj_out(o.to(x.dtype)[:, None])


def ring_rows(S: int, axis: Tuple[int, int]) -> slice:
    """This rank's rows of a ring of S rows split by sequence over a
    cache axis of (size n, this rank's index i) (the JAX
    ``cache_shardings``' "model", or ("data", "model") at a batch of 1,
    on the cache's seq; ``parallel/ops.serve_placement``); raises where n
    does not divide S, a ring the JAX placement would replicate."""
    n, i = axis
    if S % n:
        raise ValueError(f"a ring of {S} rows does not divide over a cache "
                         f"axis of {n} ranks")
    return slice(i * (S // n), (i + 1) * (S // n))


def init_cache(batch: int, seq: int, n_kv: int, head_dim: int,
               window: Optional[int], dtype: torch.dtype,
               device: torch.device,
               axis: Tuple[int, int] = (1, 0)) -> Dict[str, torch.Tensor]:
    """KV cache tensors; window layers keep a ring buffer of ``window``
    rows; over a cache axis (``axis``: its size and this rank's index,
    ``parallel/ops.serve_placement``) this rank's rows of it."""
    rows = ring_rows(min(seq, window) if window is not None else seq, axis)
    shape = (batch, rows.stop - rows.start, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
