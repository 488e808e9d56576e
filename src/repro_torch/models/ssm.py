"""Mamba (selective SSM) block: the chunked scan of a prompt and the
O(1)-state decode step. Used by jamba-v0.1-52b (``BlockSpec(mixer=
"mamba")``).

Ported from ``repro/models/ssm.py``. The prompt's linear recurrence
h_t = exp(dt*A) h_{t-1} + dt*B*x_t runs in float32, a log-depth
(Hillis-Steele) scan within each chunk of ``CHUNK`` tokens and a loop
across chunks, which bounds the (B, chunk, d_inner, d_state)
intermediates as the JAX package's ``associative_scan`` inside
``lax.scan`` does. The JAX package computes the block with XLA ops and no
Pallas kernel, so the port computes it with PyTorch ops; its projections
are cuBLAS matmuls, as the dense layers' are. ``parallel/ops.shard`` is a
no-op without a mesh and is dropped.

Weights (a ``layers.Mixer`` over ``mamba_forward`` and
``mamba_decode`` holds them): ``in_proj`` (d, 2*di), ``conv_w`` (K, di),
``conv_b`` (di,), ``x_proj`` (di, R + 2N), ``dt_w`` (R, di), ``dt_b``
(di,), ``D`` (di,), ``out_proj`` (di, d) in the compute type, and
``A_log`` (di, N) in float32, as the JAX package reads it.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

CHUNK = 512      # tokens a scan chunk (repro/models/ssm.py::mamba_forward)


def chunk_of(L: int, chunk: int) -> int:
    """The scan's chunk for an L-token prompt: ``min(chunk, L)``, which
    must divide L (the JAX package asserts it; the port raises)."""
    c = min(chunk, L)
    if L < 1 or L % c:
        raise ValueError(f"a prompt of {L} tokens: the scan takes lengths "
                         f"up to {chunk} or multiples of {chunk}")
    return c


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, taps unrolled in x's type, summed in tap
    order. x (B, L, di); w (K, di); b (di,) -> (B, L, di)."""
    K, L = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = torch.zeros_like(x)
    for i in range(K):
        out = out + xp[:, i:i + L] * w[i]
    return out + b


def conv_step(conv_in: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The conv of a decode step, the JAX package's einsum over the K taps
    of conv_in (B, K, di): exact products summed in float32, rounded once
    to conv_in's type. -> (B, di)."""
    return (conv_in.float() * w.float()).sum(1).to(conv_in.dtype)


def linear_scan_(a: torch.Tensor, b: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan along dim 1 of the affine maps h -> a_t h + b_t, in
    place: a becomes prod_{s<=t} a_s and b the state h_t from h = 0, in
    ceil(log2 L) steps (Hillis-Steele). Each step combines position t
    with t - s into fresh tensors, then writes them back."""
    s, n = 1, a.shape[1]
    while s < n:
        nb = torch.addcmul(b[:, s:], a[:, s:], b[:, :-s])
        na = a[:, s:] * a[:, :-s]
        b[:, s:] = nb
        a[:, s:] = na
        del nb, na
        s *= 2
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``linear_scan_`` out of place, for autograd: the same steps and
    the same bits, each step's result a new tensor."""
    s, n = 1, a.shape[1]
    while s < n:
        b = torch.cat([b[:, :s], torch.addcmul(b[:, s:], a[:, s:], b[:, :-s])],
                      dim=1)
        a = torch.cat([a[:, :s], a[:, s:] * a[:, :-s]], dim=1)
        s *= 2
    return a, b


def mamba_forward(x: torch.Tensor, p: Mapping[str, torch.Tensor], *,
                  d_state: int, chunk: int = CHUNK
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prefill. x (B, L, d) in the compute type -> (out (B, L, d), cache
    with the final state ``h`` (B, di, N) float32 and the conv tail
    ``conv``: the last K-1 rows of the conv's input, fewer when L < K-1,
    as the JAX package slices them). Under autograd the scan runs out of
    place (``linear_scan``), to the same bits; serving scans in place."""
    B, L, _ = x.shape
    c = chunk_of(L, chunk)
    di = p["in_proj"].shape[-1] // 2
    dt_rank = p["dt_w"].shape[-2]
    xin, z = (x @ p["in_proj"]).split(di, dim=-1)
    xc = F.silu(causal_conv(xin, p["conv_w"], p["conv_b"]))
    dt, Bc, Cc = (xc @ p["x_proj"]).split([dt_rank, d_state, d_state],
                                          dim=-1)
    dt = F.softplus(dt @ p["dt_w"] + p["dt_b"])
    A = -torch.exp(p["A_log"].float())                        # (di, N)
    dt32, B32, C32, x32 = dt.float(), Bc.float(), Cc.float(), xc.float()
    h = torch.zeros(B, di, d_state, dtype=torch.float32, device=x.device)
    ys = []
    for i in range(0, L, c):
        dt_c = dt32[:, i:i + c, :, None]                      # (B,c,di,1)
        dA = torch.exp(dt_c * A)                              # (B,c,di,N)
        dBx = dt_c * B32[:, i:i + c, None, :] * x32[:, i:i + c, :, None]
        if torch.is_grad_enabled():
            cum_a, h_loc = linear_scan(dA, dBx)
            hs = h_loc.addcmul(cum_a, h[:, None])
        else:
            cum_a, h_loc = linear_scan_(dA, dBx)
            hs = h_loc.addcmul_(cum_a, h[:, None])
        del cum_a
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, C32[:, i:i + c]))
        h = hs[:, -1].clone()
        del hs, h_loc
    y = torch.cat(ys, dim=1).to(x.dtype) + xc * p["D"]
    out = (y * F.silu(z)) @ p["out_proj"]
    K = p["conv_w"].shape[-2]
    return out, {"h": h, "conv": xin[:, L - (K - 1):].clone()}


def mamba_decode(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                 cache: Mapping[str, torch.Tensor], *, d_state: int
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token a row. x (B, 1, d); cache ``h`` (B, di, N), ``conv``
    (B, K-1, di) -> (out (B, 1, d), the new cache)."""
    di = p["in_proj"].shape[-1] // 2
    dt_rank = p["dt_w"].shape[-2]
    xin, z = (x @ p["in_proj"]).split(di, dim=-1)             # (B,1,di)
    conv_in = torch.cat([cache["conv"], xin], dim=1)          # (B,K,di)
    xc = F.silu(conv_step(conv_in, p["conv_w"])[:, None] + p["conv_b"])
    dt, Bc, Cc = (xc @ p["x_proj"]).split([dt_rank, d_state, d_state],
                                          dim=-1)
    dt = F.softplus(dt @ p["dt_w"] + p["dt_b"])
    A = -torch.exp(p["A_log"].float())
    dt32 = dt[:, 0].float()[..., None]                        # (B,di,1)
    dA = torch.exp(dt32 * A)                                  # (B,di,N)
    dBx = dt32 * Bc[:, 0, None, :].float() * xc[:, 0, :, None].float()
    h = dA * cache["h"] + dBx
    y = torch.einsum("bdn,bn->bd", h, Cc[:, 0].float())[:, None]
    y = y.to(x.dtype) + xc * p["D"]
    out = (y * F.silu(z)) @ p["out_proj"]
    return out, {"h": h, "conv": conv_in[:, 1:]}


def init_mamba_cache(batch: int, d: int, *, d_state: int, d_conv: int,
                     expand: int, dtype: torch.dtype,
                     device: torch.device) -> Dict[str, torch.Tensor]:
    di = d * expand
    return {"h": torch.zeros(batch, di, d_state, dtype=torch.float32,
                             device=device),
            "conv": torch.zeros(batch, d_conv - 1, di, dtype=dtype,
                                device=device)}

