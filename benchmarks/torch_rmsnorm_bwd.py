"""rmsnorm's backward kernel against the two-launch design before it, on the card.

    PYTHONPATH=src python -m benchmarks.torch_rmsnorm_bwd
    PYTHONPATH=src python -m benchmarks.torch_rmsnorm_bwd --old OLD.cu --iters 50

The earlier design (a rows kernel writing 264 partial rows of dscale,
then a second kernel adding them column by column) is built from
``csrc/rmsnorm.cu`` as it stood at commit ``0d98a24``: ``git show`` of
that file when the checkout has its history, or the file given by
``--old`` (for example from ``git archive 0d98a24`` unpacked into a
directory that ``.gitignore`` lists). A shim appended to that source
exports each of its two launches alone. It is built with the port's
nvcc flags into ``build/variants/`` and loaded with ctypes beside the
port's kernel (``repro_torch.kernels.rmsnorm.rmsnorm_bwd``).

At each (rows, D, type), on the same inputs: the port's kernel against
the plain version ``ref.rmsnorm_bwd`` (float32 within 1e-4, bfloat16
within 2e-2 of the largest entry), its bits on a second launch, its dx
bit for bit against the earlier kernel's, the largest difference of the
two dscales, and the kernels one call of each puts in a CUDA graph
(``build.graph_kernels``). Then device times from CUDA events with the
launches queued ahead, in turns (earlier, port, its rows launch alone,
its dscale launch alone, ``F.rms_norm``'s backward, and back in the
reverse order), the bound (x and dy read once, dx written once, scale
read and dscale written once, over 3.35 TB/s) and each one's share of
it. The card's name and power limit come first; the rows go to stdout
and, as JSON, to ``results/torch_rmsnorm_bwd.json``. Needs a CUDA
card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, ref
from repro_torch.kernels import rmsnorm as rms

ROOT = Path(__file__).resolve().parents[1]
PARENT = "0d98a24"
SOURCE = "src/repro_torch/kernels/csrc/rmsnorm.cu"
PEAK_BYTES_PER_S = 3.35e12
LEAD_CYCLES = 20_000_000     # about 11 ms of the card's clock
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # relative to max
# granite-moe-3b-a800m's training norm (4096 tokens of 1536), and the
# zoo's other widths over the same rows: xlstm-125m 768, h2o-danube-1.8b
# 2560, jamba-v0.1-52b 4096, the kernel's widest row 8192
SHAPES = [(4096, d, dt) for d in (1536, 768, 2560, 4096, 8192)
          for dt in (torch.bfloat16, torch.float32)]
OLD_PARTIALS = 264           # the earlier design's partial rows
# each of the earlier design's launches alone: appended to its source
SHIM = r'''
namespace {
template <typename T, int K>
int shim_rows_k(const T* x, const float* sc, const T* dy, T* dx, float* pt,
                long long rows, int D, int tpr, float eps, cudaStream_t s) {
  const int rpb = kBlock / tpr;
  const long long need = (rows + rpb - 1) / rpb;
  const int blocks = (int)(need < kPartials ? need : kPartials);
  rmsnorm_bwd_rows<T, K, true><<<blocks, kBlock, 0, s>>>(x, sc, dy, dx, pt,
                                                        rows, D, tpr, eps);
  const cudaError_t e = cudaGetLastError();
  return e == cudaSuccess ? blocks : -(int)e;
}

template <typename T>
int shim_rows(const void* x, const void* sc, const void* dy, void* dx,
              void* pt, long long rows, int D, float eps, cudaStream_t s) {
  constexpr int n = Vec<T>::kN;
  const int nvec = (D + n - 1) / n;
  int tpr = 32;
  while (tpr < kBlock && nvec > Vec<T>::kMaxK * tpr) tpr *= 2;
  const int k = (nvec + tpr - 1) / tpr;
#define SHIM_K(K)                                                          \
  case K:                                                                  \
    return shim_rows_k<T, K>((const T*)x, (const float*)sc, (const T*)dy, \
                             (T*)dx, (float*)pt, rows, D, tpr, eps, s);
  switch (k) { SHIM_K(1) SHIM_K(2) SHIM_K(3) SHIM_K(4) }
  if constexpr (Vec<T>::kMaxK > 4) {
    switch (k) { SHIM_K(5) SHIM_K(6) SHIM_K(7) SHIM_K(8) }
  }
  return -(int)cudaErrorInvalidValue;
}
}  // namespace

// the rows launch alone (16-byte vectors only): its block count, or a
// negated CUDA error
extern "C" int shim_bwd_rows(const void* x, const void* scale,
                             const void* dy, void* dx, void* partials,
                             int dtype, long long rows, int D, float eps,
                             void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return shim_rows<float>(x, scale, dy, dx, partials, rows, D, eps, s);
  return shim_rows<__nv_bfloat16>(x, scale, dy, dx, partials, rows, D, eps,
                                  s);
}

// the dscale launch alone, over `blocks` partial rows
extern "C" int shim_bwd_scale(const void* partials, void* dscale,
                              int blocks, int D, void* stream) {
  rmsnorm_bwd_scale<<<(D + kBlock - 1) / kBlock, kBlock, 0,
                      (cudaStream_t)stream>>>((const float*)partials,
                                              (float*)dscale, blocks, D);
  return (int)cudaGetLastError();
}
'''


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def old_source(path) -> str:
    if path:
        return Path(path).read_text()
    return subprocess.run(["git", "show", f"{PARENT}:{SOURCE}"], cwd=ROOT,
                          capture_output=True, text=True,
                          check=True).stdout


def load_old(text: str) -> ctypes.CDLL:
    """The earlier design with the shim, built with the port's flags."""
    out_dir = build.BUILD_DIR.parent / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "rmsnorm_bwd_parent.cu"
    src.write_text(text + SHIM)
    lib_path = out_dir / "librmsnorm_bwd_parent.so"
    proc = subprocess.run([build._tool("nvcc"), *build.NVCC_FLAGS,
                           f"-I{build.CSRC}", "-o", str(lib_path), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on the earlier design:\n"
                           f"{proc.stdout}{proc.stderr}")
    for r in build.resources(proc.stdout + proc.stderr):
        if "bwd" in r["kernel"]:
            print(f"ptxas earlier {r['kernel']}: {r['registers']} registers, "
                  f"{r['spill_stores']} B spill stores, {r['smem']} B smem")
    lib = ctypes.CDLL(str(lib_path))
    ptr = ctypes.c_void_p
    for name, args in (
            ("rmsnorm_bwd", [ptr] * 6 + [ctypes.c_int, ctypes.c_longlong,
                                         ctypes.c_int, ctypes.c_float, ptr]),
            ("shim_bwd_rows", [ptr] * 5 + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_int, ctypes.c_float,
                                           ptr]),
            ("shim_bwd_scale", [ptr, ptr, ctypes.c_int, ctypes.c_int,
                                ptr])):
        getattr(lib, name).argtypes = args
        getattr(lib, name).restype = ctypes.c_int
    return lib


def time_ms(fn, iters: int) -> float:
    """Mean device ms of ``fn`` over ``iters`` launches queued while the
    card spins, so that the events time the device alone."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(LEAD_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def stream() -> int:
    """The current stream (a graph capture runs on a stream of its own)."""
    return torch.cuda.current_stream().cuda_stream


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) / max(
        float(want.float().abs().max()), 1e-30)


def measure(old, rows: int, d: int, dt, iters: int) -> dict:
    device = torch.device("cuda")
    g = torch.Generator(device=device).manual_seed(d)
    x = (torch.randn((rows, d), generator=g, device=device) * 3).to(dt)
    scale = 1 + 0.1 * torch.randn((d,), generator=g, device=device)
    dy = torch.randn((rows, d), generator=g, device=device).to(dt)
    code = build.dtype_code(x)
    dx_old = torch.empty_like(x)
    ds_old = torch.empty(d, dtype=torch.float32, device=device)
    partials = torch.empty((OLD_PARTIALS, d), dtype=torch.float32,
                           device=device)
    ptrs = (x.data_ptr(), scale.data_ptr(), dy.data_ptr(), dx_old.data_ptr(),
            partials.data_ptr())

    def earlier():
        err = old.rmsnorm_bwd(*ptrs, ds_old.data_ptr(), code, rows, d, 1e-6,
                              stream())
        assert err == 0, f"earlier rmsnorm_bwd: CUDA error {err}"

    blocks = old.shim_bwd_rows(*ptrs, code, rows, d, 1e-6, stream())
    assert blocks > 0, f"earlier rows launch: CUDA error {-blocks}"

    def rows_alone():
        old.shim_bwd_rows(*ptrs, code, rows, d, 1e-6, stream())

    def scale_alone():
        old.shim_bwd_scale(partials.data_ptr(), ds_old.data_ptr(), blocks, d,
                           stream())

    ins = [t.detach().clone().requires_grad_(True) for t in (x, scale.to(dt))]
    out = F.rms_norm(ins[0], (d,), ins[1], 1e-6)

    def library():
        torch.autograd.grad(out, ins, dy, retain_graph=True)

    dx, ds = rms.rmsnorm_bwd(x, scale, dy)
    want = ref.rmsnorm_bwd(x, scale, dy)
    again = rms.rmsnorm_bwd(x, scale, dy)
    earlier()
    torch.cuda.synchronize()
    nodes_new = build.graph_kernels(lambda: rms.rmsnorm_bwd(x, scale, dy))
    nodes_old = build.graph_kernels(earlier)
    row = {"rows": rows, "D": d, "dtype": str(dt)[6:],
           "rel_err": max(rel_err(dx, want[0]), rel_err(ds, want[1])),
           "bits_repeat": bool(torch.equal(dx, again[0]) and
                               torch.equal(ds, again[1])),
           "dx_bits_equal_earlier": bool(torch.equal(dx, dx_old)),
           "dx_max_diff_earlier": float((dx.float() - dx_old.float()).abs()
                                        .max()),
           "dscale_rel_diff_earlier": rel_err(ds, ds_old),
           "graph_nodes": len(nodes_new),
           "graph_kernels": [n for n in nodes_new],
           "graph_nodes_earlier": len(nodes_old),
           "earlier_blocks": blocks}
    fns = {"earlier": earlier, "port": lambda: rms.rmsnorm_bwd(x, scale, dy),
           "earlier_rows": rows_alone, "earlier_dscale": scale_alone,
           "library": library}
    order = list(fns) + list(reversed(fns))
    times = {k: [] for k in fns}
    for k in order:
        times[k].append(time_ms(fns[k], iters))
    size = x.element_size()
    nbytes = 3 * rows * d * size + 8 * d
    bound = nbytes / PEAK_BYTES_PER_S * 1e3
    row.update({f"{k}_ms": sum(v) / len(v) for k, v in times.items()})
    row.update({f"{k}_turns_ms": v for k, v in times.items()})
    row.update({"bound_ms": bound, "bound_by": "bytes", "bytes": nbytes,
                "share": bound / row["port_ms"],
                "share_earlier": bound / row["earlier_ms"]})
    ok = row["rel_err"] <= TOL[dt] and row["bits_repeat"] and \
        row["graph_nodes"] == 1
    row["ok"] = ok
    print(f"rmsnorm_bwd {rows}x{d} {row['dtype']}: port {row['port_ms']:.4f} "
          f"ms ({row['share']:.3f} of the bound {bound:.4f} ms), earlier "
          f"{row['earlier_ms']:.4f} ms ({row['share_earlier']:.3f}; rows "
          f"launch {row['earlier_rows_ms']:.4f}, dscale launch "
          f"{row['earlier_dscale_ms']:.4f}), F.rms_norm backward "
          f"{row['library_ms']:.4f} ms; rel err {row['rel_err']:.3e}, bits "
          f"repeat {row['bits_repeat']}, dx bit for bit the earlier's "
          f"{row['dx_bits_equal_earlier']} (max diff "
          f"{row['dx_max_diff_earlier']:.3e}), dscale vs earlier "
          f"{row['dscale_rel_diff_earlier']:.3e}; graph nodes "
          f"{row['graph_nodes']} {nodes_new} (earlier "
          f"{row['graph_nodes_earlier']})" + ("" if ok else "  FAILED"))
    return row


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", help="the earlier rmsnorm.cu (default: git "
                    f"show {PARENT}:{SOURCE})")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--shapes", default=None,
                    help="rows x D x type list, e.g. 4096x1536xbfloat16,"
                         "4096x1536xfloat32")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_rmsnorm_bwd: needs a CUDA card")
    shapes = SHAPES
    if args.shapes:
        shapes = [(int(r), int(d), getattr(torch, t)) for r, d, t in
                  (s.split("x") for s in args.shapes.split(","))]
    print(card_line())
    old = load_old(old_source(args.old))
    build.build("rmsnorm")
    for r in build.resources(build.logs.get("rmsnorm", "")):
        if "bwd" in r["kernel"]:
            print(f"ptxas port {r['kernel']}: {r['registers']} registers, "
                  f"{r['spill_stores']} B spill stores, {r['smem']} B smem")
    out = [measure(old, rows, d, dt, args.iters) for rows, d, dt in shapes]
    path = ROOT / "results" / "torch_rmsnorm_bwd.json"
    path.parent.mkdir(exist_ok=True)
    path.write_text(json.dumps({"card": card_line(), "rows": out}, indent=1))
    return 0 if all(r["ok"] for r in out) else 1


if __name__ == "__main__":
    raise SystemExit(main())
