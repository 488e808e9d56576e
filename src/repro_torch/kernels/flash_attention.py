"""Flash attention's CUDA kernel (prefill): binding and wrapper.

``flash_attention(q, k, v, causal=, window=, q_offset=)`` replaces
``repro/kernels/flash_attention.py::flash_attention``, the Pallas TPU
kernel: causal and/or sliding-window attention with an online softmax.
It takes the compact GQA ``k, v`` (B, Sk, KV, D) and any lengths; the
TPU kernel takes k, v expanded to every query head and lengths that are
multiples of its blocks. Its source is ``csrc/flash_attention.cu``; the
note there gives its design and its bound. In bfloat16 it runs on
Hopper's tensor cores (``wgmma`` for Q.K^T and P.V, K and V tiles brought
by TMA), so it needs an ``sm_90a`` card, and rounds P to bfloat16 before
P.V, as the model's own attention does (the plain version and the TPU
kernel keep it float32; the two agree within 2e-2). In float32 it runs
on the CUDA cores, since the tensor cores would round float32 operands
to TF32.

Under autograd (a grad-enabled call where q, k or v requires grad) the
call goes through ``FlashAttentionFn``: the forward kernel also writes
each row's log-sum-exp (float32 (B, H, Sq); serving passes a null
pointer and writes none), and the backward is ``flash_attention_bwd``,
two hand-written kernels in ``csrc/flash_attention_bwd.cu`` (dQ with
each row's Delta = rowsum(dO * O), then dK and dV, a kv head's group
summed in one block in a fixed order; no atomics). In bfloat16 at head
dims up to 128 both run on the tensor cores (``wgmma``, tiles by TMA)
and round P and dS to bfloat16 before their products; in float32, and
at D 256, on the CUDA cores. On the CPU the backward is the plain
``ref.attention_bwd``.

A tensor on the CPU goes to the plain version in ``kernels/ref.py``. A
tensor on the card launches the kernel or raises: there is no fallback.
A tensor on ``meta`` (the dry run) is checked as the card's would be and
gets empty results of the right shapes; nothing is launched. ``cost``
and ``bwd_cost`` give the kernels' operations and bytes from their
shapes (and the (q, k) pairs the mask keeps, ``kept_pairs``), which the
wrapper reports to the op count (``kernels/count.py``) when one is
active, on every device.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import build, count, ref

HEAD_DIMS = (16, 32, 64, 80, 128, 256)   # the head dims the kernel compiles
SIGNATURES = {"flash_attention_fwd": [ctypes.c_void_p] * 5 +
              [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]}
BWD_SIGNATURES = {"flash_attention_bwd": [ctypes.c_void_p] * 10 +
                  [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]}


def kept_pairs(sq: int, sk: int, window: Optional[int],
               q_offset: int = 0, causal: bool = True) -> int:
    """(q, k) pairs of one (batch, head) that the mask keeps: query row i
    at position ``q_offset + i`` (q aligned to the end of k when
    ``q_offset`` is 0 and Sq != Sk, as the kernel resolves it) keeps key
    j iff j <= pos (causal) and j > pos - window."""
    if q_offset == 0 and sq != sk:
        q_offset = sk - sq
    pos = np.arange(sq, dtype=np.int64) + q_offset
    hi = np.minimum(pos, sk - 1) if causal else np.full_like(pos, sk - 1)
    lo = np.maximum(0, pos - window + 1) if window else np.zeros_like(pos)
    return int(np.sum(np.maximum(hi - lo + 1, 0)))


def cost(q_shape, k_shape, dtype: torch.dtype, *, causal: bool = True,
         window: Optional[int] = None, q_offset: int = 0,
         with_lse: bool = False):
    """(operations, bytes) of one forward launch: 4·D operations a kept
    (q, k) pair of each query head (Q.K^T and P.V); q, k and v read and
    the output written once, and with ``with_lse`` the float32
    log-sum-exp written."""
    B, Sq, H, D = q_shape
    Sk, KV = k_shape[1], k_shape[2]
    pairs = B * kept_pairs(Sq, Sk, window, q_offset, causal)
    nbytes = (2 * B * Sq * H * D + 2 * B * Sk * KV * D) * dtype.itemsize
    return 4 * D * H * pairs, nbytes + (4 * B * H * Sq if with_lse else 0)


def bwd_cost(q_shape, k_shape, dtype: torch.dtype, *, causal: bool = True,
             window: Optional[int] = None, q_offset: int = 0):
    """(operations, bytes) of one backward call (its two launches): 10·D
    operations a kept pair of each query head (S and dP recomputed, dQ,
    dK, dV); q, the output, dout and dq, and k, v, dk, dv each crossing
    memory once, and the log-sum-exp read."""
    B, Sq, H, D = q_shape
    Sk, KV = k_shape[1], k_shape[2]
    pairs = B * kept_pairs(Sq, Sk, window, q_offset, causal)
    nbytes = (4 * B * Sq * H * D + 4 * B * Sk * KV * D) * dtype.itemsize
    return 10 * D * H * pairs, nbytes + 4 * B * H * Sq


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Sk, KV, D), KV dividing H -> (B, Sq, H,
    D) in q's type. Query row i sits at absolute position ``q_offset +
    i``; when ``q_offset`` is 0 and Sq != Sk, q is aligned to the end of
    k. ``flash_attention.launches`` counts the kernel's launches.
    Differentiable (``FlashAttentionFn``)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, causal, window, q_offset)
    return _forward(q, k, v, causal, window, q_offset, False)[0]


def _check(q, k, v, window) -> int:
    code = build.dtype_code(q, k, v)
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"attention takes q (B,Sq,H,D), k = v (B,Sk,KV,D); "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or KV == 0 or H % KV:
        raise ValueError(f"k {tuple(k.shape)} does not fit q {tuple(q.shape)}")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"attention runs on cpu, cuda or meta, not "
                         f"{q.device}")
    if q.device.type != "cpu":
        if D not in HEAD_DIMS:
            raise ValueError(f"head dim {D} is not one the kernel compiles "
                             f"{HEAD_DIMS}")
        build.check_launchable(q, k, v)
    return code


def _resolve_offset(q, k, q_offset: int) -> int:
    Sq, Sk = q.shape[1], k.shape[1]
    return Sk - Sq if q_offset == 0 and Sq != Sk else q_offset


def _forward(q, k, v, causal, window, q_offset, with_lse: bool):
    """(out, lse): lse (B, H, Sq) float32 when ``with_lse`` on the card,
    else None."""
    code = _check(q, k, v, window)
    with (count.kernel("flash_attention", cost(
            q.shape, k.shape, q.dtype, causal=causal, window=window,
            q_offset=q_offset, with_lse=with_lse), q.dtype)
          if count.ACTIVE else count.NOT_COUNTING):
        if q.device.type == "cpu":
            return ref.attention(q, k, v, causal=causal, window=window,
                                 q_offset=q_offset), None
        if q.device.type == "meta":
            B, Sq, H, _ = q.shape
            return build.empty_like(q), torch.empty(
                (B, H, Sq), dtype=torch.float32, device=q.device) \
                if with_lse else None
        return _launch(q, k, v, causal, window, q_offset, with_lse, code)


def _launch(q, k, v, causal, window, q_offset, with_lse, code):
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    q_offset = _resolve_offset(q, k, q_offset)
    out = torch.empty_like(q)
    lse = None
    if with_lse:
        lse = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
        if Sk == 0:
            lse.fill_(float("-inf"))
    build.launch(build.load("flash_attention", SIGNATURES)
                 .flash_attention_fwd, q.device, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), code, B, Sq, Sk, H,
                 KV, D, int(causal), window or 0, q_offset, 1.0 / D ** 0.5,
                 what=f"flash_attention at q {tuple(q.shape)}, "
                      f"k {tuple(k.shape)}")
    flash_attention.launches += 1
    return out, lse


def flash_attention_bwd(q, k, v, out, lse, dout, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0):
    """The gradients (dq, dk, dv), in the inputs' types, of
    ``flash_attention`` at its output ``out`` (and on the card the
    forward's log-sum-exp ``lse``) for the output gradient ``dout``. On
    the card two kernels (dQ, then dK and dV); ``flash_attention_bwd.
    launches`` counts the calls that launch them."""
    code = _check(q, k, v, window)
    if dout.shape != q.shape or dout.dtype != q.dtype or \
            out.shape != q.shape or out.dtype != q.dtype:
        raise ValueError(f"out and dout must match q {tuple(q.shape)}")
    with (count.kernel("flash_attention_bwd", bwd_cost(
            q.shape, k.shape, q.dtype, causal=causal, window=window,
            q_offset=q_offset), q.dtype)
          if count.ACTIVE else count.NOT_COUNTING):
        if q.device.type == "cpu":
            return ref.attention_bwd(q, k, v, out, dout, causal=causal,
                                     window=window, q_offset=q_offset)
        if q.device.type == "meta":
            return build.empty_like(q), build.empty_like(k), \
                build.empty_like(v)
        return _launch_bwd(q, k, v, out, lse, dout, causal, window,
                           q_offset, code)


def _launch_bwd(q, k, v, out, lse, dout, causal, window, q_offset, code):
    B, Sq, H, D = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if lse is None or lse.shape != (B, H, Sq) or lse.dtype != torch.float32:
        raise ValueError("the backward needs the forward's (B, H, Sq) "
                         "float32 log-sum-exp")
    dout = dout.contiguous()
    build.check_launchable(out, dout, lse)
    q_offset = _resolve_offset(q, k, q_offset)
    dq = torch.zeros_like(q) if Sk == 0 else torch.empty_like(q)
    dk = torch.zeros_like(k) if Sq == 0 else torch.empty_like(k)
    dv = torch.zeros_like(v) if Sq == 0 else torch.empty_like(v)
    delta = torch.empty((B, H, Sq), dtype=torch.float32, device=q.device)
    build.launch(build.load("flash_attention_bwd", BWD_SIGNATURES)
                 .flash_attention_bwd, q.device, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), dout.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), code, B, Sq, Sk, H, KV, D,
                 int(causal), window or 0, q_offset, 1.0 / D ** 0.5,
                 what=f"flash_attention_bwd at q {tuple(q.shape)}, "
                      f"k {tuple(k.shape)}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Attention under autograd: the forward kernel with its log-sum-exp,
    then ``flash_attention_bwd`` (q, k, v, the output and the log-sum-exp
    saved)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        out, lse = _forward(q, k, v, causal, window, q_offset, True)
        ctx.args = (causal, window, q_offset)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, q_offset = ctx.args
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=causal, window=window,
                                         q_offset=q_offset)
        return dq, dk, dv, None, None, None


flash_attention.launches = 0
flash_attention_bwd.launches = 0
