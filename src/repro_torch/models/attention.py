"""GQA attention block: prefill through the flash-attention kernel,
decode through the decode-attention kernel over a ring cache.

Ported from ``repro/models/attention.py``. Layout: flat query heads
(B, S, H, D) and compact kv heads (B, S, KV, D); query head h reads kv
head h // (H / KV), and the kernels take the compact kv as it is.

The JAX package pads the query heads up to a multiple of its 16-way
tensor-parallel axis (``padded_heads``) and masks the padded heads so
that they add exactly zero. The port runs on one card, so it keeps only
the real heads: ``models/convert.py`` drops the padded heads' weights,
which changes no output. ``parallel/ops.shard`` is a no-op without a
mesh and is dropped too.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn

from repro_torch.kernels import ops
from repro_torch.models import layers


def padded_heads(n_heads: int, tp: int = 16) -> int:
    """H rounded up to a multiple of tp (only if not already divisible):
    the JAX package's query-head count."""
    return -(-n_heads // tp) * tp if n_heads % tp else n_heads


class Attention(nn.Module):
    """Weights wq (d, H*D), wk and wv (d, KV*D), wo (H*D, d), in the JAX
    package's (d, heads, head_dim) order; in the compute type when
    serving, or held in the parameter type and cast to ``cdt`` at use
    when training."""

    def __init__(self, wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
                 wo: torch.Tensor, *, n_heads: int, n_kv: int,
                 window: Optional[int], rope_theta: float,
                 cdt: Optional[torch.dtype] = None, trainable: bool = False):
        super().__init__()
        self.n_heads, self.n_kv = n_heads, n_kv
        self.head_dim = wq.shape[-1]
        self.window = window
        self.rope_theta = rope_theta
        self.cdt = cdt
        d = wq.shape[0]
        self.wq = layers.weight(wq.reshape(d, -1), trainable)
        self.wk = layers.weight(wk.reshape(d, -1), trainable)
        self.wv = layers.weight(wv.reshape(d, -1), trainable)
        self.wo = layers.weight(wo.reshape(-1, wo.shape[-1]), trainable)

    def _proj_qkv(self, x: torch.Tensor):
        """x (B, S, d) -> q (B, S, H, D), k and v (B, S, KV, D)."""
        B, S, _ = x.shape
        q = (x @ layers.use(self.wq, self.cdt)).view(B, S, self.n_heads,
                                                     self.head_dim)
        k = (x @ layers.use(self.wk, self.cdt)).view(B, S, self.n_kv,
                                                     self.head_dim)
        v = (x @ layers.use(self.wv, self.cdt)).view(B, S, self.n_kv,
                                                     self.head_dim)
        return q, k, v

    def _proj_out(self, o: torch.Tensor) -> torch.Tensor:
        B, S = o.shape[:2]
        return o.reshape(B, S, -1) @ layers.use(self.wo, self.cdt)

    def forward(self, x: torch.Tensor, positions: torch.Tensor
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Prefill (``attn_forward``). x (B, S, d) -> (out, (k, v)) with
        the compact roped k, v for the cache."""
        q, k, v = self._proj_qkv(x)
        q = layers.apply_rope(q, positions, self.rope_theta)
        k = layers.apply_rope(k, positions, self.rope_theta)
        o = ops.attention(q, k, v, causal=True, window=self.window)
        return self._proj_out(o), (k, v)

    def decode(self, x: torch.Tensor, cache: Dict[str, torch.Tensor],
               pos: torch.Tensor) -> torch.Tensor:
        """Decode one token per row (``attn_decode``). x (B, 1, d); cache
        k, v (B, S, KV, D) ring buffers, written in place: the new roped
        k, v go to ring row ``pos % S``; pos (B,) int32 absolute
        positions, on x's device."""
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


def init_cache(batch: int, seq: int, n_kv: int, head_dim: int,
               window: Optional[int], dtype: torch.dtype,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """KV cache tensors; window layers keep a ring buffer of ``window``
    rows."""
    s = min(seq, window) if window is not None else seq
    shape = (batch, s, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
