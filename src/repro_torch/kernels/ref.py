"""Plain PyTorch versions of the hand-written kernels (the references).

Each function is the mathematical definition with no tiling or fusion:
the CPU tests run it against the JAX package's references, and
``chip_smoke.py`` holds each kernel against it on the card. The
backward passes (``rmsnorm_bwd``, ``attention_bwd``, ``moe_gmm_bwd``)
are written as explicit formulas, not through autograd: the tests hold
them to ``torch.autograd`` of the forward and to ``jax.vjp`` of the JAX
package's references.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def same_pad(size: int, stride: int, k: int = 3) -> Tuple[int, int, int]:
    """``(out, before, after)`` of XLA's SAME padding along one axis.

    The total is ``(out - 1) * stride + k - size`` and the smaller half
    goes *before*: for an even size at stride 2 that is no row at the
    top and one at the bottom, which ``F.conv2d(padding=1)`` gets wrong.
    """
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return out, total // 2, total - total // 2


def fp32_conv():
    """cuDNN runs float32 convolutions in TF32 by default, which keeps
    about three digits and breaks the 1e-4 agreement with the JAX
    package; this context pins full float32 (and deterministic
    algorithms, so a seeded training run repeats). Matmuls already run
    in float32: ``torch.backends.cuda.matmul.allow_tf32`` stays False."""
    return torch.backends.cudnn.flags(enabled=True, allow_tf32=False,
                                      deterministic=True)


def conv_scorer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                stride: int = 2) -> torch.Tensor:
    """3x3 SAME conv + bias + relu. x: (N, H, W, Cin); w: (3,3,Cin,Cout).

    The counterpart of ``repro/kernels/ref.py::conv_scorer``, in full
    float32 on the card (``fp32_conv``)."""
    _, H, W, _ = x.shape
    _, top, bottom = same_pad(H, stride)
    _, left, right = same_pad(W, stride)
    xp = F.pad(x.float().permute(0, 3, 1, 2), (left, right, top, bottom))
    with fp32_conv():
        out = F.conv2d(xp, w.float().permute(3, 2, 0, 1), stride=stride)
    out = torch.relu(out + b.float()[:, None, None])
    return out.permute(0, 2, 3, 1).contiguous().to(x.dtype)


def conv_scorer_grouped(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                        stride: int = 2) -> torch.Tensor:
    """``conv_scorer`` of each member with its own weights: x (Q, N, H,
    W, Cin), w (Q, 3, 3, Cin, Cout), b (Q, Cout) -> (Q, N, Ho, Wo, Cout)
    (``jax.vmap`` of the reference over the leading axis)."""
    return torch.stack([conv_scorer(x[q], w[q], b[q], stride)
                        for q in range(x.shape[0])])


def scorer_head(h: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor,
                wh: torch.Tensor, bh: torch.Tensor) -> torch.Tensor:
    """The scorer's dense and head layers, ``relu(h @ wd + bd) @ wh + bh``
    (``repro/core/runtime.py``'s scorer body, l.200-201). h (M, feat) ->
    (M, 2)."""
    return torch.relu(h @ wd + bd) @ wh + bh


def scorer_head_grouped(h: torch.Tensor, wd: torch.Tensor, bd: torch.Tensor,
                        wh: torch.Tensor, bh: torch.Tensor) -> torch.Tensor:
    """``scorer_head`` of each member with its own weights: every
    argument with a leading member axis Q -> (Q, M, 2)."""
    return torch.stack([scorer_head(h[q], wd[q], bd[q], wh[q], bh[q])
                        for q in range(h.shape[0])])


NEG_INF = -1e30


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * scale`` per row in float32, cast
    back to x's type (``repro/kernels/ref.py::rmsnorm``)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor,
                eps: float = 1e-6):
    """The gradients of ``rmsnorm``: with r = rsqrt(mean(x^2) + eps) per
    row, ``dx = r (dy s) - x r^3 mean(dy s x)`` in x's type and
    ``dscale = sum over rows of dy x r`` in float32."""
    x32, dy32, s = x.float(), dy.float(), scale.float()
    r = torch.rsqrt(x32.square().mean(dim=-1, keepdim=True) + eps)
    dot = (dy32 * s * x32).mean(dim=-1, keepdim=True)
    dx = r * (dy32 * s) - x32 * r.pow(3) * dot
    dscale = (dy32 * x32 * r).reshape(-1, x.shape[-1]).sum(dim=0)
    return dx.to(x.dtype), dscale


def expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """Compact GQA (..., KV, D) -> (..., H, D): query head h reads kv
    head h // (H / KV), the model's grouping for its real heads."""
    n_kv = k.shape[-2]
    return k if n_kv == n_heads else \
        k.repeat_interleave(n_heads // n_kv, dim=-2)


def keep_mask(sq: int, sk: int, causal: bool, window: Optional[int],
              q_offset: int, device) -> torch.Tensor:
    """(Sq, Sk) bool: query row i (position ``q_offset + i``; q aligned
    to the end of k when ``q_offset`` is 0 and Sq != Sk) keeps key j iff
    ``j <= pos`` (causal) and ``j > pos - window``."""
    if q_offset == 0 and sq != sk:
        q_offset = sk - sq
    qpos = torch.arange(sq, device=device)[:, None] + q_offset
    kpos = torch.arange(sk, device=device)[None, :]
    keep = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        keep &= kpos <= qpos
    if window is not None:
        keep &= kpos > qpos - window
    return keep


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Sk, KV, D) with KV dividing H.

    Query row i sits at absolute position ``q_offset + i``; when
    ``q_offset`` is 0 and Sq != Sk, q is aligned to the end of k
    (``repro/kernels/ref.py::attention`` and the Pallas kernel's
    convention). A pair is kept iff ``kpos <= qpos`` (causal) and
    ``kpos > qpos - window``. Float32 scores and softmax, cast back to
    q's type. The loop over kv heads bounds the scores' memory at long
    sequences."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    keep = keep_mask(Sq, Sk, causal, window, q_offset, q.device)
    g = H // KV
    outs = []
    for j in range(KV):
        qj = q[:, :, j * g:(j + 1) * g].float()                 # (B,Sq,g,D)
        s = torch.einsum("bqgd,bsd->bgqs", qj, k[:, :, j].float()) / (D ** 0.5)
        p = torch.softmax(s.masked_fill(~keep, NEG_INF), dim=-1)
        outs.append(torch.einsum("bgqs,bsd->bqgd", p, v[:, :, j].float()))
    return torch.cat(outs, dim=2).to(q.dtype)


def attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, dout: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0):
    """The gradients (dq, dk, dv) of ``attention`` at its output ``out``
    for the output gradient ``dout``, in the inputs' types. Per kv head
    j and its group of query heads, in float32, with s the scaled scores
    and P their softmax over the kept keys: ``dV = P^T dO``, ``dP = dO
    V^T``, ``Delta = rowsum(dO * out)``, ``dS = P (dP - Delta)``, ``dQ =
    dS K / sqrt(D)``, ``dK = dS^T Q / sqrt(D)``, dK and dV summed over
    the group's heads."""
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    keep = keep_mask(Sq, Sk, causal, window, q_offset, q.device)
    g, scale = H // KV, 1.0 / D ** 0.5
    dqs, dks, dvs = [], [], []
    for j in range(KV):
        heads = slice(j * g, (j + 1) * g)
        qj, oj = q[:, :, heads].float(), out[:, :, heads].float()
        dj = dout[:, :, heads].float()                       # (B,Sq,g,D)
        kj, vj = k[:, :, j].float(), v[:, :, j].float()       # (B,Sk,D)
        s = torch.einsum("bqgd,bsd->bgqs", qj, kj) * scale
        p = torch.softmax(s.masked_fill(~keep, NEG_INF), dim=-1)
        p = p.masked_fill(~keep, 0.0)                         # empty rows
        dp = torch.einsum("bqgd,bsd->bgqs", dj, vj)
        delta = (dj * oj).sum(-1).permute(0, 2, 1)[..., None]  # (B,g,Sq,1)
        ds = p * (dp - delta)
        dvs.append(torch.einsum("bgqs,bqgd->bsd", p, dj))
        dks.append(torch.einsum("bgqs,bqgd->bsd", ds, qj) * scale)
        dqs.append(torch.einsum("bgqs,bsd->bqgd", ds, kj) * scale)
    dq = torch.cat(dqs, dim=2).to(q.dtype)
    return (dq, torch.stack(dks, dim=2).to(k.dtype),
            torch.stack(dvs, dim=2).to(v.dtype))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B, H, D) against the compact ring cache k, v (B, S, KV, D).

    ``pos`` (B,): the model's validity mask (``repro/models/attention.py
    ::decode_attention``): ring row r is valid iff ``r <= pos`` or
    ``pos >= S``; None means every row is valid (the Pallas kernel's
    function). Float32 scores, softmax and P.V (the model rounds p to
    the cache type first; the kernels keep it float32), cast back to
    q's type."""
    H, D = q.shape[1], q.shape[2]
    S = k.shape[1]
    s = torch.einsum("bhd,bshd->bhs", q.float(),
                     expand_kv(k, H).float()) / (D ** 0.5)
    if pos is not None:
        rows = torch.arange(S, device=q.device)[None, :]
        p = pos.to(q.device).long()[:, None]
        valid = (rows <= p) | (p >= S)                            # (B, S)
        s = s.masked_fill(~valid[:, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", p, expand_kv(v, H).float())
    return out.to(q.dtype)


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped matmul: x (E, C, d) @ w (E, d, f) -> (E, C, f), in float32
    and rounded once to x's type (``repro/kernels/ref.py::moe_gmm``)."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


def moe_gmm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor):
    """The gradients of ``moe_gmm``: ``dx[e] = dy[e] @ w[e]^T`` in x's
    type and ``dw[e] = x[e]^T @ dy[e]`` in w's type, each summed in
    float32."""
    dx = torch.einsum("ecf,edf->ecd", dy.float(), w.float()).to(x.dtype)
    dw = torch.einsum("ecd,ecf->edf", x.float(), dy.float()).to(w.dtype)
    return dx, dw
