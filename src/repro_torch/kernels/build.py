"""Build of the hand-written CUDA kernels in ``csrc/``.

``load(name, signatures)`` compiles ``csrc/<name>.cu`` with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
and loads it with ``ctypes``; each kernel's wrapper gives the
``argtypes`` of its own C functions, which all return a CUDA error code.
The library lives in ``build/repro_torch/`` under the repository root,
keyed by a hash of the source and the flags, so a changed source is
rebuilt. Nothing runs at import time. The helpers at the end are the
checks every wrapper makes before it hands raw pointers to a kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
logs: Dict[str, str] = {}   # nvcc's output of each build (registers, spills)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "first use and need the CUDA toolkit")
    return str(path)


def source(name: str) -> Path:
    return CSRC / f"{name}.cu"


def library_path(name: str) -> Path:
    """Where the build of ``csrc/<name>.cu`` for this source, the shared
    headers ``csrc/*.cuh`` and these flags lives."""
    h = hashlib.sha256(source(name).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless this source's build exists. The
    library is written under a temporary name and renamed, so two
    processes building at once cannot load a half-written file."""
    lib = library_path(name)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source(name))],
            capture_output=True, text=True, check=False)
        logs[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {name}.cu:\n{logs[name]}")
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def load(name: str, signatures: Dict[str, Sequence]) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if need be, with
    each C function of ``signatures`` bound to its ``argtypes`` and an
    ``int`` result (pointers and the stream are ``c_void_p``: ctypes
    would cut a pointer passed as a plain int)."""
    if name not in _LIBS:
        lib = ctypes.CDLL(str(build(name)))
        for fn_name, argtypes in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIBS[name] = lib
    return _LIBS[name]


def dtype_code(*tensors) -> int:
    """The kernels' type argument: 0 for float32, 1 for bfloat16. Every
    tensor must have the first one's type; any other type is refused."""
    dt = tensors[0].dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the kernels take float32 or bfloat16, not {dt}")
    for t in tensors[1:]:
        if t.dtype != dt:
            raise TypeError(f"mixed types: {t.dtype} beside {dt}")
    return 0 if dt == torch.float32 else 1


def check_launchable(*tensors) -> None:
    """A CUDA launch reads raw pointers: every tensor must be contiguous
    and 16-byte aligned (the kernels' vector loads)."""
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError("the kernels take contiguous tensors")
        if t.data_ptr() % 16:
            raise ValueError("the kernels take 16-byte aligned tensors")


def launch(fn, device: torch.device, *args, what: str) -> None:
    """Call the C function ``fn`` with ``args`` and the current stream of
    ``device`` last; raise if it reports a CUDA error (a launch that is
    refused never runs, and no later synchronisation would say so)."""
    with torch.cuda.device(device):
        err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{what}: kernel launch failed, CUDA error {err}")
