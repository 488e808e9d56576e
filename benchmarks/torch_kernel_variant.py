"""A kernel of the port against another build of it, on the card.

    PYTHONPATH=src python -m benchmarks.torch_kernel_variant KERNEL OTHER.cu
    PYTHONPATH=src python -m benchmarks.torch_kernel_variant \
        decode_attention OTHER.cu --splits 64,128,256
    PYTHONPATH=src python -m benchmarks.torch_kernel_variant \
        rmsnorm_bwd A.cu B.cu ...

KERNEL is ``conv_scorer``, ``rmsnorm``, ``rmsnorm_bwd``,
``decode_attention`` or ``scorer_head``; OTHER.cu is a source with the
same C functions as ``src/repro_torch/kernels/csrc/KERNEL.cu``
(``rmsnorm.cu`` for both norms; an older version taken from git, or a
copy with other constants) in a directory that ``.gitignore`` lists;
several sources are built in parallel and each is compared in turn. It
is built with the port's nvcc flags, with ``csrc/`` on the
include path, and at the shapes the main paths give the kernel (every
conv layer of the reduced operator family at N 1024; the norms of
h2o-danube-1.8b, granite-moe-3b-a800m and granite-20b; the decode ticks
of h2o-danube-1.8b, granite-moe-3b-a800m, llama4-maverick-400b-a17b and
granite-20b, 8 slots over 4096 ring rows, in bf16 and float32; the
operator family's dense and head layers at M 1, 20, 32, 64 and 1024;
rmsnorm's backward over 4096 rows of the zoo's widths, in both types,
every variant in turns: port, A, B, ..., B, A, port)
both builds run on the same inputs: whether their outputs are equal bit
for bit, their largest difference, and each one's device time, in turns
(port, other, other, port), beside the library call that computes the
same function (cuDNN in float32, ``F.rms_norm``, SDPA with the rows
masked; the dense and head layers have none). A decode source of the
first design (one that exports ``decode_attention_split_rows`` and picks
its own split) is called through its own C interface. ``--splits`` also times the port's decode
kernel at each of those split sizes. The card's name and power limit
come first. Needs a CUDA card and nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import build, conv_scorer as cs, ref
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import rmsnorm as rms
from repro_torch.kernels import scorer_head as sh

# (H, Cin, Cout) of every conv layer of the reduced operator family
FAMILY_LAYERS = [(100, 3, 32), (50, 32, 32), (25, 32, 32), (13, 32, 32),
                 (7, 32, 32), (50, 3, 16), (25, 16, 16), (13, 16, 16),
                 (7, 16, 16), (25, 3, 8), (13, 8, 8)]
# (rows, D, type) of the served norms
NORMS = [(2048, 2560, torch.bfloat16), (8, 2560, torch.bfloat16),
         (2048, 2560, torch.float32), (2048, 1536, torch.bfloat16),
         (8, 1536, torch.bfloat16), (2048, 6144, torch.bfloat16),
         (2048, 6144, torch.float32)]
# (rows, D, type) of the trained norms' backward: granite-moe-3b-a800m's
# 4096 tokens of 1536, xlstm-125m's 768, h2o-danube-1.8b's 2560,
# jamba-v0.1-52b's 4096
NORMS_BWD = [(4096, d, dt) for d in (1536, 768, 2560, 4096)
             for dt in (torch.bfloat16, torch.float32)]
# (H, KV, D, model) of the served decode ticks, B 8 over 4096 ring rows
DECODES = [(32, 8, 80, "h2o-danube-1.8b"), (24, 8, 64, "granite-moe-3b"),
           (40, 8, 128, "llama4-maverick"), (48, 1, 128, "granite-20b")]
# (feat, dense) of the operator family's dense and head layers
HEADS = [(392, 16), (784, 32), (256, 32), (512, 64)]
HEAD_ROWS = (1, 20, 32, 64, 1024)
MODULES = {"conv_scorer": cs, "rmsnorm": rms, "rmsnorm_bwd": rms,
           "decode_attention": da, "scorer_head": sh}
# the first decode design's C interface: the same arguments without the
# split, which it chooses itself (decode_attention_split_rows)
OLD_DECODE = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [
    ctypes.c_float, ctypes.c_void_p]
# the later designs' whole-ring interface (decode_attention_fwd): the
# caller's split, no row offset and no log-sum-exp
FWD_DECODE = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
    ctypes.c_float, ctypes.c_void_p]


def load_variant(kernel: str, source: Path):
    """The C function of ``source``, built as ``kernel``'s library (for
    decode attention and rmsnorm's backward the library itself: the one's
    interface depends on its design, the other has two functions)."""
    out = build.BUILD_DIR / f"variant_{kernel}_{source.stem}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build._tool("nvcc"), *build.NVCC_FLAGS,
                           f"-I{build.CSRC}", "-o", str(out), str(source)],
                          check=True, capture_output=True, text=True)
    for r in build.resources(proc.stdout + proc.stderr):
        if kernel != "rmsnorm_bwd" or "bwd" in r["kernel"]:
            print(f"ptxas {source.name} {r['kernel']}: {r['registers']} "
                  f"registers, {r['spill_stores']} B spill stores")
    lib = ctypes.CDLL(str(out))
    if kernel == "decode_attention":
        return lib
    sigs = MODULES[kernel].SIGNATURES
    if kernel.startswith("rmsnorm"):   # one source, both directions
        wanted = ["rmsnorm_fwd"] if kernel == "rmsnorm" else [
            "rmsnorm_bwd_partials", "rmsnorm_bwd"]
        sigs = {k: sigs[k] for k in wanted}
    for name, argtypes in sigs.items():
        getattr(lib, name).argtypes = argtypes
        getattr(lib, name).restype = ctypes.c_int
    return lib if kernel == "rmsnorm_bwd" else getattr(lib, name)


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


def in_turns(port, other, library=None) -> dict:
    fns = {"port": port, "other": other, "library": library}
    order = ("port", "other", "library", "library", "other", "port")
    t = {k: [] for k in fns if fns[k] is not None}
    for name in order:
        if fns[name] is not None:
            t[name].append(device_ms(fns[name]))
    return {k: float(np.mean(v)) for k, v in t.items()}


def report(what, mine, theirs, t, name) -> bool:
    same = torch.equal(mine, theirs)
    diff = float((mine.float() - theirs.float()).abs().max())
    lib = f"{t['library']:.4f} ms" if "library" in t else "none"
    print(f"{what}: equal bit for bit {same}, max|diff| {diff:.3e}; port "
          f"{t['port']:.4f} ms, {name} {t['other']:.4f} ms, library {lib}")
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


def norm_bwd_cases(libs, names) -> bool:
    """Each variant's backward (its own partial rows) against the port's:
    dx and dscale bit for bit, and device times, all in turns."""
    dev = torch.device("cuda")
    same_all = True
    for rows, d, dt in NORMS_BWD:
        g = torch.Generator(device=dev).manual_seed(rows + d)
        x = (3 * torch.randn(rows, d, generator=g, device=dev)).to(dt)
        scale = 1 + 0.1 * torch.randn(d, generator=g, device=dev)
        dy = torch.randn(rows, d, generator=g, device=dev).to(dt)
        code = build.dtype_code(x)
        fns = {"port": lambda: rms.rmsnorm_bwd(x, scale, dy)}
        for lib, name in zip(libs, names):
            dx = torch.empty_like(x)
            ds = torch.empty(d, device=dev)
            ptrs = (x.data_ptr(), scale.data_ptr(), dy.data_ptr(),
                    dx.data_ptr())
            with torch.cuda.device(dev):
                need = lib.rmsnorm_bwd_partials(*ptrs, code, rows, d)
            part = torch.empty((max(need, 0), d), device=dev)

            def other(lib=lib, ptrs=ptrs, part=part, ds=ds, dx=dx, name=name):
                build.launch(lib.rmsnorm_bwd, dev, *ptrs, part.data_ptr(),
                             ds.data_ptr(), code, rows, d, 1e-6, what=name)
                return dx, ds
            fns[name] = other
        mine = rms.rmsnorm_bwd(x, scale, dy)
        outs = {n: [t.clone() for t in fns[n]()] for n in names}
        order = list(fns) + list(reversed(fns))
        t = {n: [] for n in fns}
        for n in order:
            t[n].append(device_ms(fns[n]))
        bound = (3 * rows * d * x.element_size() + 8 * d) / 3.35e12 * 1e3
        port = float(np.mean(t["port"]))
        total = torch.empty_like(x)
        copy = device_ms(lambda: torch.add(x, dy, out=total))
        print(f"rmsnorm_bwd {rows}x{d} {str(dt)[6:]}: port {port:.4f} ms "
              f"({bound / port:.3f} of the bound {bound:.4f} ms); x + dy, "
              f"the same bytes, {copy:.4f} ms")
        for n in names:
            ms = float(np.mean(t[n]))
            same = [torch.equal(a, b) for a, b in zip(mine, outs[n])]
            same_all &= all(same)
            print(f"  {n}: {ms:.4f} ms ({bound / ms:.3f} of the bound); dx, "
                  f"dscale bit for bit the port's {same}, dscale max|diff| "
                  f"{float((mine[1] - outs[n][1]).abs().max()):.3e}")
    return same_all


def decode_cases(lib, name: str, splits) -> bool:
    dev = torch.device("cuda")
    B, S = 8, 4096
    # chip_smoke.py's tick: 7 slots at seeded positions, one past the wrap
    pos = np.random.default_rng(0).integers(0, S, size=B)
    pos[-1] = S + 904
    tpos = torch.tensor(pos, dtype=torch.int32, device=dev)
    old = hasattr(lib, "decode_attention_split_rows")
    fn = lib.decode_attention_fwd
    fn.argtypes = OLD_DECODE if old else FWD_DECODE
    fn.restype = ctypes.c_int
    if old:
        lib.decode_attention_split_rows.argtypes = []
        lib.decode_attention_split_rows.restype = ctypes.c_int
    port = build.load("decode_attention", da.SIGNATURES).decode_attention_fwd
    port.argtypes, port.restype = FWD_DECODE, ctypes.c_int
    same_all = True
    for H, KV, D, model in DECODES:
        for dt in (torch.bfloat16, torch.float32):
            g = torch.Generator(device=dev).manual_seed(H + D)
            q = torch.randn((B, H, D), generator=g, device=dev).to(dt)
            k = torch.randn((B, S, KV, D), generator=g, device=dev).to(dt)
            v = torch.randn((B, S, KV, D), generator=g, device=dev).to(dt)
            out = torch.empty_like(q)
            code = build.dtype_code(q)
            if old:
                rows = lib.decode_attention_split_rows()
                part = torch.empty(B * H * -(-S // rows) * (D + 2),
                                   device=dev)

                def other():
                    build.launch(fn, dev, q.data_ptr(), k.data_ptr(),
                                 v.data_ptr(), tpos.data_ptr(),
                                 out.data_ptr(), part.data_ptr(), code, B, H,
                                 KV, S, D, 1.0 / D ** 0.5, what=name)
                    return out
            else:
                other = split_call(fn, name, q, k, v, tpos, out,
                                   da.split_rows(S, D, H // KV, dt))
            mask = ((torch.arange(S, device=dev)[None, :] <=
                     tpos[:, None].long()) |
                    (tpos[:, None].long() >= S))[:, None, None, :]
            qt = q[:, :, None]
            kt = ref.expand_kv(k, H).transpose(1, 2)
            vt = ref.expand_kv(v, H).transpose(1, 2)
            mine = da.decode_attention(q, k, v, tpos)
            theirs = other().clone()
            err = float((mine.float() - ref.decode_attention(
                q, k, v, tpos).float()).abs().max())
            what = (f"decode_attention {model} {H}/{KV}x{D} {str(dt)[6:]} "
                    f"(split {da.split_rows(S, D, H // KV, dt)}, max|err| "
                    f"against the plain version {err:.3e})")
            same_all &= report(what, mine, theirs, in_turns(
                lambda: da.decode_attention(q, k, v, tpos), other,
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       attn_mask=mask)),
                name)
            for split in splits:
                call = split_call(port, f"split {split}", q, k, v, tpos,
                                  torch.empty_like(q), split)
                got = call()
                print(f"  port at split {split}: "
                      f"{device_ms(call):.4f} ms, equal to the port's "
                      f"split {torch.equal(got, mine)}")
            del q, k, v, kt, vt
            torch.cuda.empty_cache()
    return same_all


def split_call(fn, name, q, k, v, tpos, out, split):
    """The new C interface at a given split size, into ``out``."""
    dev = q.device
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    part = torch.empty(da.scratch_floats(B, H, S, D, split), device=dev)
    code = build.dtype_code(q)

    def call():
        build.launch(fn, dev, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     tpos.data_ptr(), out.data_ptr(), part.data_ptr(), code,
                     B, H, KV, S, D, split, 1.0 / D ** 0.5, what=name)
        return out
    return call


def head_cases(fn, name: str) -> bool:
    dev = torch.device("cuda")
    same_all = True
    for feat, dense in HEADS:
        g = torch.Generator(device=dev).manual_seed(feat + dense)
        h = torch.rand(max(HEAD_ROWS), feat, generator=g, device=dev)
        wd = torch.randn(feat, dense, generator=g, device=dev) * \
            (2.0 / feat) ** 0.5
        bd = 0.1 * torch.randn(dense, generator=g, device=dev)
        wh = torch.randn(dense, 2, generator=g, device=dev) / dense ** 0.5
        bh = 0.1 * torch.randn(2, generator=g, device=dev)
        for m in HEAD_ROWS:
            hm = h[-m:].contiguous()
            out = torch.empty((m, 2), device=dev)

            def other():
                build.launch(fn, dev, hm.data_ptr(), wd.data_ptr(),
                             bd.data_ptr(), wh.data_ptr(), bh.data_ptr(),
                             out.data_ptr(), m, feat, dense, what=name)
                return out

            mine = sh.scorer_head(hm, wd, bd, wh, bh)
            same_all &= report(
                f"scorer_head M={m} {feat}->{dense}->2", mine,
                other().clone(),
                in_turns(lambda: sh.scorer_head(hm, wd, bd, wh, bh), other),
                name)
    return same_all


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kernel", choices=sorted(MODULES))
    ap.add_argument("source", type=Path, nargs="+")
    ap.add_argument("--n", type=int, default=1024,
                    help="images of a conv_scorer call")
    ap.add_argument("--splits", default="",
                    help="decode: also time the port at these split sizes "
                         "(comma-separated multiples of 64)")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    with ThreadPoolExecutor(len(args.source)) as pool:
        fns = list(pool.map(lambda src: load_variant(args.kernel, src),
                            args.source))
    names = [src.name for src in args.source]
    if args.kernel == "rmsnorm_bwd":
        same = norm_bwd_cases(fns, names)
    for fn, name in zip(fns, names):
        if args.kernel == "conv_scorer":
            same = conv_cases(fn, name, args.n)
        elif args.kernel == "rmsnorm":
            same = norm_cases(fn, name)
        elif args.kernel == "decode_attention":
            same = decode_cases(fn, name, [int(x) for x in
                                           args.splits.split(",") if x])
        elif args.kernel == "scorer_head":
            same = head_cases(fn, name)
        print(f"{name}: every shape equal bit for bit: {same}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
