"""The conv scorer's CUDA kernel: build, binding and wrapper.

``conv_scorer(x, w, b)`` replaces ``repro/kernels/conv_scorer.py::
conv_scorer``, the Pallas TPU kernel: a fused 3x3 SAME conv + bias +
ReLU over NHWC float32. Its source is ``csrc/conv_scorer.cu``; the note
there gives its design and its bound on the card.

A tensor on the CPU goes to the plain version in ``kernels/ref.py``. A
tensor on the card launches the kernel or raises: there is no fallback.
The kernel is built at first use, with ``nvcc`` for ``sm_90a``, into
``build/repro_torch/`` under the repository root, and rebuilt when the
source changes. Nothing CUDA-specific happens at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "conv_scorer.cu"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# 9 * Cin * Cout + Cout floats of weights and bias in shared memory; a
# block may use at most 227 KB on Hopper
MAX_SMEM_BYTES = 232_448

_LIB: Optional[ctypes.CDLL] = None
build_log = ""          # nvcc's output of the last build (registers, spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the conv_scorer kernel is built "
                           "on first use and needs the CUDA toolkit")
    return str(path)


def library_path() -> Path:
    """Where the build for the current source and flags lives."""
    digest = hashlib.sha256(SOURCE.read_bytes() +
                            " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"libconv_scorer_{digest}.so"


def build() -> Path:
    """Compile ``csrc/conv_scorer.cu`` unless this source's build exists.
    The library is written under a temporary name and renamed, so two
    processes building at once cannot load a half-written file."""
    global build_log
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True, check=False)
        build_log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{build_log}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.conv_scorer_f32
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 +
                       [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
           stride: int) -> None:
    if x.dim() != 4 or w.dim() != 4 or b.dim() != 1:
        raise ValueError("conv_scorer takes x (N,H,W,Cin), w (3,3,Cin,Cout), "
                         f"b (Cout,); got {tuple(x.shape)}, {tuple(w.shape)}, "
                         f"{tuple(b.shape)}")
    cin, cout = x.shape[-1], w.shape[-1]
    if tuple(w.shape[:3]) != (3, 3, cin) or b.shape[0] != cout:
        raise ValueError(f"weights {tuple(w.shape)} / bias {tuple(b.shape)} "
                         f"do not fit {cin} input channels")
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    for name, t in (("x", x), ("w", w), ("b", b)):
        if t.dtype != torch.float32:
            raise TypeError(f"conv_scorer takes float32; {name} is {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if (9 * cin * cout + cout) * 4 > MAX_SMEM_BYTES:
        raise ValueError(f"{cin}x{cout} weights exceed the kernel's shared "
                         "memory")


def conv_scorer(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                stride: int = 2) -> torch.Tensor:
    """Fused 3x3 SAME conv + bias + ReLU. x: (N, H, W, Cin) float32
    NHWC, w: (3, 3, Cin, Cout) HWIO -> (N, Ho, Wo, Cout).

    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``conv_scorer.launches`` counts each launch) or raise."""
    _check(x, w, b, stride)
    if x.device.type == "cpu":
        return ref.conv_scorer(x, w, b, stride)
    if x.device.type != "cuda":
        raise ValueError(f"conv_scorer runs on cpu or cuda, not {x.device}")
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("conv_scorer takes contiguous tensors")
    n, h, wd, cin = x.shape
    cout = w.shape[-1]
    ho, top, _ = ref.same_pad(h, stride)
    wo, left, _ = ref.same_pad(wd, stride)
    out = torch.empty((n, ho, wo, cout), device=x.device, dtype=torch.float32)
    if out.numel() == 0:
        return out
    fn = _library().conv_scorer_f32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = fn(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                 n, h, wd, cin, cout, ho, wo, stride, top, left, stream)
    if err != 0:
        raise RuntimeError(f"conv_scorer kernel launch failed: CUDA error "
                           f"{err} at x {tuple(x.shape)}, w {tuple(w.shape)}")
    conv_scorer.launches += 1
    return out


conv_scorer.launches = 0
