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

A tensor on the CPU goes to the plain version in ``kernels/ref.py``. A
tensor on the card launches the kernel or raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (16, 32, 64, 80, 128, 256)   # the head dims the kernel compiles
SIGNATURES = {"flash_attention_fwd": [ctypes.c_void_p] * 4 +
              [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p]}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, H, D); k, v (B, Sk, KV, D), KV dividing H -> (B, Sq, H,
    D) in q's type. Query row i sits at absolute position ``q_offset +
    i``; when ``q_offset`` is 0 and Sq != Sk, q is aligned to the end of
    k. ``flash_attention.launches`` counts the kernel's launches."""
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
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window,
                             q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"attention runs on cpu or cuda, not {q.device}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} is not one the kernel compiles "
                         f"{HEAD_DIMS}")
    build.check_launchable(q, k, v)
    if q_offset == 0 and Sq != Sk:
        q_offset = Sk - Sq
    out = torch.empty_like(q)
    build.launch(build.load("flash_attention", SIGNATURES)
                 .flash_attention_fwd, q.device, q.data_ptr(), k.data_ptr(),
                 v.data_ptr(), out.data_ptr(), code, B, Sq, Sk, H, KV, D,
                 int(causal), window or 0, q_offset, 1.0 / D ** 0.5,
                 what=f"flash_attention at q {tuple(q.shape)}, "
                      f"k {tuple(k.shape)}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
