"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, a sequential scan), arXiv:2405.04517. Used by
xlstm-125m.

Ported from ``repro/models/xlstm.py``, whose docstring derives the
chunkwise form of the stabilized mLSTM recurrence. The JAX package
computes both blocks with XLA ops and no Pallas kernel, so the port
computes them with PyTorch ops: the mLSTM a loop over chunks of
``CHUNK`` tokens, the sLSTM one step a token (the recurrence through
``r`` is sequential). Gates, states and the per-head norm run in
float32, as in the JAX package.

Weights (a ``layers.Mixer`` holds them) in the compute type except
``gn_scale`` and the sLSTM's ``r``, which stay float32 (the JAX package
reads them so). mLSTM: ``w_up`` (d, 2*di), ``conv_w`` (CONV, di),
``conv_b`` (di,), ``wq``, ``wk``, ``wv`` (di, di), ``w_if`` (di, 2H),
``b_if`` (2H,), ``gn_scale`` (di,), ``w_down`` (di, d). sLSTM: ``w_in``
(d, 4d), ``b_in`` (4d,), ``r`` (H, dh, 4*dh), ``gn_scale`` (d,),
``ff_up`` (d, 2*ffs), ``ff_down`` (ffs, d).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.ssm import causal_conv, chunk_of, conv_step

CHUNK = 256      # tokens a chunk (repro/models/xlstm.py::mlstm_chunked)
CONV = 4         # taps of the mLSTM's causal conv
State = Tuple[torch.Tensor, ...]


def _headify(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    B, L, di = x.shape
    return x.reshape(B, L, n_heads, di // n_heads)


def _head_rmsnorm(h: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Per-head RMS norm in float32. h (B, L, H, Dh); scale (H*Dh,) ->
    (B, L, H*Dh) in h's type."""
    B, L, H, Dh = h.shape
    h32 = h.float()
    y = h32 * torch.rsqrt(h32.square().mean(-1, keepdim=True) + eps)
    return (y.reshape(B, L, H * Dh) * scale.float()).to(h.dtype)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_chunked(q, k, v, log_f, g, state: State, *, chunk: int = CHUNK):
    """q, k, v (B, L, H, Dh) (k unscaled); log_f, g (B, L, H); state (C
    (B, H, Dh, Dh), n (B, H, Dh), m (B, H)) stabilized, float32 ->
    (h (B, L, H, Dh) in q's type, final state)."""
    B, L, H, Dh = q.shape
    c = chunk_of(L, chunk)
    scale = 1.0 / (Dh ** 0.5)
    mask = torch.ones(c, c, dtype=torch.bool, device=q.device).tril()
    C0, n0, m0 = state
    hs = []
    for i in range(0, L, c):
        qf = q[:, i:i + c].float()
        kf = k[:, i:i + c].float() * scale
        vf = v[:, i:i + c].float()
        b = torch.cumsum(log_f[:, i:i + c].float(), dim=1)     # (B,c,H)
        gb = g[:, i:i + c].float() - b
        M = torch.maximum(torch.cummax(gb, dim=1).values, m0[:, None])
        s_qk = torch.einsum("bthd,bshd->bhts", qf, kf)
        w_log = gb.transpose(1, 2)[:, :, None, :] - \
            M.transpose(1, 2)[..., None]                      # (B,H,t,s)
        # masked before the exp: for s > t, gb_s - M_t can exceed exp's
        # range (M_t is a running max only up to t)
        sw = s_qk * torch.exp(w_log.masked_fill(~mask, float("-inf")))
        inter = torch.exp(m0[:, None] - M)                    # (B,c,H)
        num = torch.einsum("bhts,bshd->bthd", sw, vf) + \
            torch.einsum("bthd,bhde->bthe", qf, C0) * inter[..., None]
        den = sw.sum(-1).transpose(1, 2) + \
            torch.einsum("bthd,bhd->bth", qf, n0) * inter
        m_t = b + M
        hs.append(num / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])
        # the carry, weighted relative to M at the chunk's end
        Mc = M[:, -1]                                         # (B,H)
        u = torch.exp(gb - Mc[:, None])                       # (B,c,H)
        decay = torch.exp(m0 - Mc)
        C0 = decay[..., None, None] * C0 + \
            torch.einsum("bshd,bshe->bhde", u[..., None] * kf, vf)
        n0 = decay[..., None] * n0 + torch.einsum("bsh,bshd->bhd", u, kf)
        m0 = b[:, -1] + Mc
    h = torch.cat(hs, dim=1)
    return h.to(q.dtype), (C0, n0, m0)


def mlstm_step(q, k, v, log_f, g, state: State):
    """One decode step. q, k, v (B, H, Dh); log_f, g (B, H) float32."""
    C, n, m = state
    Dh = q.shape[-1]
    kf = k.float() / (Dh ** 0.5)
    qf, vf = q.float(), v.float()
    m_new = torch.maximum(log_f + m, g)
    fp = torch.exp(log_f + m - m_new)
    ip = torch.exp(g - m_new)
    C = fp[..., None, None] * C + ip[..., None, None] * \
        torch.einsum("bhd,bhe->bhde", kf, vf)
    n = fp[..., None] * n + ip[..., None] * kf
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    den = torch.einsum("bhd,bhd->bh", qf, n)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h.to(q.dtype), (C, n, m_new)


def init_mlstm_state(batch: int, n_heads: int, dh: int,
                     device: torch.device) -> State:
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros(batch, n_heads, dh, dh, **f32),
            torch.zeros(batch, n_heads, dh, **f32),
            torch.full((batch, n_heads), -1e30, **f32))


def init_mlstm_cache(batch: int, d: int, *, n_heads: int, expand: int,
                     dtype: torch.dtype, device: torch.device) -> Dict:
    """The decode cache of ``mlstm_forward``: its initial state and a
    zeroed conv tail (batch, CONV-1, di)."""
    di = d * expand
    return {"state": init_mlstm_state(batch, n_heads, di // n_heads, device),
            "conv": torch.zeros(batch, CONV - 1, di, dtype=dtype,
                                device=device)}


def _mlstm_gates(xc, xm, p, n_heads):
    """q, k, v (B, L, H, Dh) and the float32 gate pre-activations (g,
    log_f) (B, L, H) of the conv'd input xc and the raw input xm."""
    q = _headify(xc @ p["wq"], n_heads)
    k = _headify(xc @ p["wk"], n_heads)
    v = _headify(xm @ p["wv"], n_heads)
    g, f_pre = (xc @ p["w_if"] + p["b_if"]).float().split(n_heads, dim=-1)
    return q, k, v, g, F.logsigmoid(f_pre)


def mlstm_forward(x: torch.Tensor, p: Mapping[str, torch.Tensor], *,
                  n_heads: int):
    """mLSTM block from the initial state. x (B, L, d) pre-normed ->
    (out, cache: ``state`` and the conv tail ``conv``, the last CONV-1
    rows of xm, fewer when L < CONV-1)."""
    B, L, _ = x.shape
    di = p["w_up"].shape[-1] // 2
    xm, z = (x @ p["w_up"]).split(di, dim=-1)
    xc = F.silu(causal_conv(xm, p["conv_w"], p["conv_b"]))
    q, k, v, g, log_f = _mlstm_gates(xc, xm, p, n_heads)
    h, state = mlstm_chunked(q, k, v, log_f, g,
                             init_mlstm_state(B, n_heads, di // n_heads,
                                              x.device))
    out = (_head_rmsnorm(h, p["gn_scale"]) * F.silu(z)) @ p["w_down"]
    return out, {"state": state, "conv": xm[:, L - (CONV - 1):].clone()}


def mlstm_decode(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                 cache: Mapping, *, n_heads: int):
    """x (B, 1, d); cache ``state`` (C, n, m), ``conv`` (B, K-1, di)."""
    di = p["w_up"].shape[-1] // 2
    xm, z = (x @ p["w_up"]).split(di, dim=-1)
    conv_in = torch.cat([cache["conv"], xm], dim=1)           # (B,K,di)
    xc = F.silu(conv_step(conv_in, p["conv_w"])[:, None] + p["conv_b"])
    q, k, v, g, log_f = _mlstm_gates(xc, xm, p, n_heads)
    h, state = mlstm_step(q[:, 0], k[:, 0], v[:, 0], log_f[:, 0], g[:, 0],
                          cache["state"])
    out = (_head_rmsnorm(h[:, None], p["gn_scale"]) * F.silu(z)) @ \
        p["w_down"]
    return out, {"state": state, "conv": conv_in[:, 1:]}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def ff_size(d: int, ff_expand: float) -> int:
    """The sLSTM's folded FFN width: d * ff_expand rounded to 64."""
    return int(round(d * ff_expand / 64)) * 64 or 64


def _slstm_gate_step(pre: torch.Tensor, st: State) -> State:
    """pre (B, H, 4*dh) gate pre-activations; st (c, n, h, m), each (B,
    H, dh) float32."""
    c, n, h, m = st
    z_p, i_p, f_p, o_p = pre.float().chunk(4, dim=-1)
    z = torch.tanh(z_p)
    log_f = F.logsigmoid(f_p)
    m_new = torch.maximum(log_f + m, i_p)
    ip = torch.exp(i_p - m_new)
    fp = torch.exp(log_f + m - m_new)
    c = fp * c + ip * z
    n = fp * n + ip
    h = torch.sigmoid(o_p) * (c / torch.clamp_min(n, 1e-6))
    return (c, n, h, m_new)


def slstm_scan(pre_x: torch.Tensor, r: torch.Tensor, state: State):
    """pre_x (B, L, H, 4*dh) input-side pre-activations; r (H, dh, 4*dh)
    -> (h (B, L, H, dh) float32, final state), one step a token."""
    r32 = r.float()
    pre = pre_x.float()
    hs = []
    for t in range(pre.shape[1]):
        rec = torch.einsum("bhd,hde->bhe", state[2], r32)
        state = _slstm_gate_step(pre[:, t] + rec, state)
        hs.append(state[2])
    return torch.stack(hs, dim=1), state


def init_slstm_state(batch: int, n_heads: int, dh: int,
                     device: torch.device) -> State:
    z = torch.zeros(batch, n_heads, dh, dtype=torch.float32, device=device)
    # four tensors, none shared: the engine writes a slot's rows in place
    return (z, z + 1e-6, z.clone(), z - 1e30)


def init_slstm_cache(batch: int, d: int, *, n_heads: int,
                     device: torch.device) -> Dict:
    """The decode cache of ``slstm_forward``: its initial state."""
    return {"state": init_slstm_state(batch, n_heads, d // n_heads, device)}


def slstm_forward(x: torch.Tensor, p: Mapping[str, torch.Tensor], *,
                  n_heads: int, state: Optional[State] = None):
    """sLSTM block with its folded post-FFN (GeGLU with the tanh GELU,
    ``jax.nn.gelu``'s default). x (B, L, d) pre-normed -> (out, cache
    ``state``)."""
    B, L, d = x.shape
    dh = d // n_heads
    pre = (x @ p["w_in"] + p["b_in"]).reshape(B, L, n_heads, 4 * dh)
    if state is None:
        state = init_slstm_state(B, n_heads, dh, x.device)
    h, state = slstm_scan(pre, p["r"], state)
    hn = _head_rmsnorm(h.to(x.dtype), p["gn_scale"])
    a, b = (hn @ p["ff_up"]).chunk(2, dim=-1)
    out = (F.gelu(a, approximate="tanh") * b) @ p["ff_down"]
    return out, {"state": state}


def slstm_decode(x: torch.Tensor, p: Mapping[str, torch.Tensor],
                 cache: Mapping, *, n_heads: int):
    """x (B, 1, d): the forward of one token from the cache's state."""
    return slstm_forward(x, p, n_heads=n_heads, state=cache["state"])

