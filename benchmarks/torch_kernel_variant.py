"""A kernel of the port against another build of it, on the card.

    PYTHONPATH=src python -m benchmarks.torch_kernel_variant KERNEL OTHER.cu

KERNEL is ``conv_scorer`` or ``rmsnorm``; OTHER.cu is a source with the
same C function as ``src/repro_torch/kernels/csrc/KERNEL.cu`` (an older
version taken from git, or a copy with other constants) in a directory
that ``.gitignore`` lists. It is built with the port's nvcc flags, with
``csrc/`` on the include path, and at the shapes the main paths give the
kernel (every conv layer of the reduced operator family at N 1024; the
norms of h2o-danube-1.8b, granite-moe-3b-a800m and granite-20b) both
builds run on the same inputs: whether their outputs are equal bit for
bit, their largest difference, and each one's device time, in turns
(port, other, other, port), beside the library call that computes the
same function (cuDNN in float32, ``F.rms_norm``). The card's name and
power limit come first. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import build, conv_scorer as cs, ref
from repro_torch.kernels import rmsnorm as rms

# (H, Cin, Cout) of every conv layer of the reduced operator family
FAMILY_LAYERS = [(100, 3, 32), (50, 32, 32), (25, 32, 32), (13, 32, 32),
                 (7, 32, 32), (50, 3, 16), (25, 16, 16), (13, 16, 16),
                 (7, 16, 16), (25, 3, 8), (13, 8, 8)]
# (rows, D, type) of the served norms
NORMS = [(2048, 2560, torch.bfloat16), (8, 2560, torch.bfloat16),
         (2048, 2560, torch.float32), (2048, 1536, torch.bfloat16),
         (8, 1536, torch.bfloat16), (2048, 6144, torch.bfloat16),
         (2048, 6144, torch.float32)]
MODULES = {"conv_scorer": cs, "rmsnorm": rms}


def load_variant(kernel: str, source: Path):
    """The C function of ``source``, built as ``kernel``'s library."""
    out = build.BUILD_DIR / f"variant_{source.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build._tool("nvcc"), *build.NVCC_FLAGS,
                           f"-I{build.CSRC}", "-o", str(out), str(source)],
                          check=True, capture_output=True, text=True)
    for r in build.resources(proc.stdout + proc.stderr):
        print(f"ptxas {r['kernel']}: {r['registers']} registers, "
              f"{r['spill_stores']} B spill stores")
    lib = ctypes.CDLL(str(out))
    (name, argtypes), = MODULES[kernel].SIGNATURES.items()
    fn = getattr(lib, name)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def device_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` over ``iters`` launches after a warm-up;
    the card first spins for about 11 ms (2e7 cycles), so the host has
    queued every launch before the first one runs and the events time
    the device alone, not the host's cost of each call."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def in_turns(port, other, library) -> dict:
    t = {"port": [], "other": [], "library": []}
    for name in ("port", "other", "library", "library", "other", "port"):
        t[name].append(device_ms({"port": port, "other": other,
                                  "library": library}[name]))
    return {k: float(np.mean(v)) for k, v in t.items()}


def report(what, mine, theirs, t, name) -> bool:
    same = torch.equal(mine, theirs)
    diff = float((mine.float() - theirs.float()).abs().max())
    print(f"{what}: equal bit for bit {same}, max|diff| {diff:.3e}; port "
          f"{t['port']:.4f} ms, {name} {t['other']:.4f} ms, library "
          f"{t['library']:.4f} ms")
    return same


def conv_cases(fn, name: str, n: int) -> bool:
    dev = torch.device("cuda")
    same_all = True
    for h, cin, cout in FAMILY_LAYERS:
        rng = np.random.default_rng(h * 100 + cin + cout)
        x = torch.from_numpy(rng.uniform(size=(n, h, h, cin))
                             .astype(np.float32)).to(dev)
        w = torch.from_numpy((rng.standard_normal((3, 3, cin, cout)) /
                              np.sqrt(9 * cin)).astype(np.float32)).to(dev)
        b = torch.from_numpy(rng.standard_normal(cout).astype(np.float32)
                             ).to(dev)
        ho, top, bottom = ref.same_pad(h, 2)
        out = torch.empty((n, ho, ho, cout), device=dev)
        xp = F.pad(x.permute(0, 3, 1, 2), (top, bottom) * 2).contiguous(
            memory_format=torch.channels_last)
        w_oihw = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

        def other():
            build.launch(fn, dev, x.data_ptr(), w.data_ptr(), b.data_ptr(),
                         out.data_ptr(), n, h, h, cin, cout, ho, ho, 2, top,
                         top, what=name)
            return out

        def library():
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                return F.conv2d(xp, w_oihw, b, stride=2)

        mine = cs.conv_scorer(x, w, b)
        theirs = other().clone()
        same_all &= report(f"conv_scorer N={n} H={h} {cin}->{cout}", mine,
                           theirs, in_turns(lambda: cs.conv_scorer(x, w, b),
                                            other, library), name)
    return same_all


def norm_cases(fn, name: str) -> bool:
    dev = torch.device("cuda")
    same_all = True
    for rows, d, dt in NORMS:
        g = torch.Generator(device=dev).manual_seed(rows + d)
        x = (3 * torch.randn(rows, d, generator=g, device=dev)).to(dt)
        scale = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
        out = torch.empty_like(x)
        code = build.dtype_code(x)

        def other():
            build.launch(fn, dev, x.data_ptr(), scale.data_ptr(),
                         out.data_ptr(), code, rows, d, 1e-6, what=name)
            return out

        lib_w = scale.to(dt)
        mine = rms.rmsnorm(x, scale)
        try:
            theirs = other().clone()
        except RuntimeError as e:        # a variant that refuses the shape
            print(f"rmsnorm {rows}x{d} {str(dt)[6:]}: {e}")
            continue
        same_all &= report(f"rmsnorm {rows}x{d} {str(dt)[6:]}", mine, theirs,
                           in_turns(lambda: rms.rmsnorm(x, scale), other,
                                    lambda: F.rms_norm(x, (d,), lib_w, 1e-6)),
                           name)
    return same_all


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(MODULES))
    ap.add_argument("source", type=Path)
    ap.add_argument("--n", type=int, default=1024,
                    help="images of a conv_scorer call")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    fn = load_variant(args.kernel, args.source)
    name = args.source.name
    same = conv_cases(fn, name, args.n) if args.kernel == "conv_scorer" \
        else norm_cases(fn, name)
    print(f"every shape equal bit for bit: {same}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
