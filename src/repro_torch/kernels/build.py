"""Build of the hand-written CUDA kernels in ``csrc/``.

``load(name, signatures)`` compiles ``csrc/<name>.cu`` with ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface, at first use,
and loads it with ``ctypes``; each kernel's wrapper gives the
``argtypes`` of its own C functions, which all return a CUDA error code.
The library lives in ``build/repro_torch/`` under the repository root,
keyed by a hash of the source and the flags, so a changed source is
rebuilt. Nothing runs at import time. ``resources`` reads ptxas's
registers, spills and shared memory of each kernel from a build's log,
``sass_counts`` counts an instruction (the tensor cores' ``HGMMA``)
in each kernel of a built library, and ``graph_kernels`` lists the
kernels a call launches. The helpers at the end are the
checks every wrapper makes before it hands raw pointers to a kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
logs: Dict[str, str] = {}   # nvcc's output of each build (registers, spills)


def _tool(name: str) -> str:
    """A CUDA toolkit program (``nvcc``, ``cuobjdump``): on the PATH, or
    under ``$CUDA_HOME/bin``."""
    found = shutil.which(name)
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / name
    if not path.exists():
        raise RuntimeError(f"{name} not found: the CUDA kernels are built "
                           "on first use and need the CUDA toolkit")
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
            [_tool("nvcc"), *NVCC_FLAGS, "-o", tmp, str(source(name))],
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


def resources(log: str) -> List[dict]:
    """Each kernel of an nvcc log (``-Xptxas -v``), in order: its mangled
    name, registers a thread, spilled bytes stored and loaded, and static
    shared memory in bytes (dynamic shared memory is a launch argument and
    is not in the log)."""
    out: List[dict] = []
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        if entry:
            out.append({"kernel": entry.group(1), "registers": 0,
                        "spill_stores": 0, "spill_loads": 0, "smem": 0})
            continue
        if not out:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if spill:
            out[-1]["spill_stores"] = int(spill.group(1))
            out[-1]["spill_loads"] = int(spill.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out[-1]["registers"] = int(regs.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[-1]["smem"] = int(smem.group(1)) if smem else 0
    return out


def count_opcodes(sass: str, opcode: str) -> Dict[str, int]:
    """Instructions whose opcode starts with ``opcode`` in each function
    of ``cuobjdump -sass`` output, keyed by mangled name."""
    counts: Dict[str, int] = {}
    fn = None
    pattern = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?" +
                         re.escape(opcode))
    for line in sass.splitlines():
        head = re.search(r"Function : (\S+)", line)
        if head:
            fn = head.group(1)
            counts[fn] = 0
        elif fn is not None and pattern.search(line):
            counts[fn] += 1
    return counts


def sass_counts(name: str, opcode: str = "HGMMA") -> Dict[str, int]:
    """``count_opcodes`` over the built library of ``csrc/<name>.cu``
    (built if need be): how many ``opcode`` instructions each of its
    kernels holds, ``HGMMA`` being Hopper's warpgroup tensor-core
    instruction."""
    proc = subprocess.run([_tool("cuobjdump"), "-sass", str(build(name))],
                          capture_output=True, text=True, check=True)
    return count_opcodes(proc.stdout, opcode)


def graph_kernels(fn) -> List[str]:
    """What one call of ``fn`` puts on the current stream, captured into a
    CUDA graph and not run: the name of each kernel (mangled), or the kind
    of each other node ("memcpy", "memset", ...), in the graph's node
    order. ``fn`` must have run once before, uncaptured. Read through
    libcuda's graph API, so a copy or a transpose before a kernel cannot
    hide, as a kernel can be missing from a profiler's short trace."""
    try:
        g = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:   # a PyTorch that keeps the graph anyway
        g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    cu = ctypes.CDLL("libcuda.so.1")
    graph = ctypes.c_void_p(g.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(graph, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    cu.cuGraphGetNodes(graph, nodes, ctypes.byref(n))
    kinds = {1: "memcpy", 2: "memset", 3: "host", 4: "graph", 5: "empty"}
    out = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        if kind.value != 0:                 # not CU_GRAPH_NODE_TYPE_KERNEL
            out.append(kinds.get(kind.value, f"node type {kind.value}"))
            continue
        params = (ctypes.c_void_p * 32)()   # CUDA_KERNEL_NODE_PARAMS: func first
        name = ctypes.c_char_p()
        get = getattr(cu, "cuGraphKernelNodeGetParams_v2", None) or \
            cu.cuGraphKernelNodeGetParams
        ok = get(ctypes.c_void_p(node), params) == 0 and \
            hasattr(cu, "cuFuncGetName") and \
            cu.cuFuncGetName(ctypes.byref(name),
                             ctypes.c_void_p(params[0])) == 0
        out.append(name.value.decode() if ok and name.value else "kernel")
    del g
    return out


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


def empty_like(t: torch.Tensor) -> torch.Tensor:
    """An empty tensor of ``t``'s shape, type, device and strides. The
    kernels' wrappers give a ``meta`` result (the dry run) through it:
    the card's ``torch.empty_like`` keeps a contiguous tensor's strides,
    those of its size-1 dims included, where ``meta``'s may not, and the
    strides decide how a later ``matmul`` folds its batch (``mm`` or
    ``bmm``)."""
    return torch.empty_strided(t.size(), t.stride(), dtype=t.dtype,
                               device=t.device)


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
