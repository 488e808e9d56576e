#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's five CUDA kernels from the sources in this checkout,
all at once, prints each kernel's registers, spills and shared memory,
and counts the tensor-core instructions (HGMMA) in the SASS of the two
whose bfloat16 path runs on them (grouped expert matmul, flash
attention); then drives its paths. The ZC² query path: the conv kernel
against its plain PyTorch version at every conv layer shape of the
reduced operator family, the scoring runtime against the plain forward,
and one Retrieval query for "bus" on the 6 h Banff scene, scored
through the kernel, then once more under the CUDA profiler for the
card's busy time. The LM serving path, for h2o-danube-1.8b (dense) and
then granite-moe-3b-a800m (MoE): the rmsnorm, flash-attention,
decode-attention and (for granite) grouped expert matmul kernels against
their plain versions at the shapes serving the model gives them, the
full-width model on its kernel path against its plain path (float32,
then bfloat16), and 16 requests served by ``ServeEngine`` through the
kernels, untraced and then traced. It prints the results, the card's own
wall-clock numbers, one JSON line with every kernel, and as its last
line
``{"ok": true, "device": {"platform": "gpu", ...}}``. Any failure exits
non-zero, and so does a host without a CUDA card.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import landmarks as lm  # noqa: E402
from repro_torch.core import operators as ops  # noqa: E402
from repro_torch.core.hardware import YOLO_V3  # noqa: E402
from repro_torch.core.query import Query, make_env  # noqa: E402
from repro_torch.core.ranking import RetrievalExecutor  # noqa: E402
from repro_torch.core.runtime import OperatorRuntime, set_runtime  # noqa: E402
from repro_torch.core.stepper import drive  # noqa: E402
from repro_torch.core.video import Video, corpus  # noqa: E402
from repro_torch.kernels import build, conv_scorer as cs, ref  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.models import attention, moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

# H100 SXM data sheet: fp32 outside the tensor cores, bf16 dense on the
# tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
KERNEL_TOL = 1e-4            # tests/test_kernels.py's conv_scorer tolerance
SCORE_TOL = 1e-5
N = 1024                     # OperatorRuntime.CHUNK: the largest dispatch
FAMILY = [(2, 8, 16, 25), (3, 16, 32, 50), (4, 16, 32, 50), (5, 32, 64, 100)]
MAIN_OP = (5, 32, 64, 100)   # the full-width operator the query ships
HOURS = 6.0                  # the corpus's default scene length
KERNELS = ("conv_scorer", "rmsnorm", "flash_attention", "decode_attention",
           "moe_gmm")
LM_KERNELS = KERNELS[1:]
LM_ARCH = "h2o-danube-1.8b"  # examples/serve_lm.py's default model
MOE_ARCH = "granite-moe-3b-a800m"   # ROADMAP's MoE configuration
LM_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py
GMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 5e-2}  # tests/test_kernels.py
LOGIT_TOL = 1e-3             # float32 whole-model parity, kernel vs plain
ROUTE_LIMIT = 1e-3           # share of top-k expert sets that may differ
LEAD_CYCLES = 20_000_000     # about 11 ms of the card's clock (1.755 GHz)
# served shapes: rmsnorm rows (a 2048-token prefill, an 8-slot decode
# tick); flash-attention prompt lengths, 8192 past the 4096 window
RMS_SHAPES = ((2048, torch.bfloat16), (8, torch.bfloat16),
              (2048, torch.float32))
FLASH_SHAPES = ((257, torch.bfloat16), (257, torch.float32),
                (2048, torch.bfloat16), (2048, torch.float32),
                (8192, torch.bfloat16))
# granite-moe-3b-a800m (d 1536, 24/8 heads of 64, no window): the norm of
# a prefill and of a tick, and a 2048-token prompt's attention
MOE_RMS_SHAPES = ((2048, torch.bfloat16), (8, torch.bfloat16))
MOE_FLASH_SHAPES = ((2048, torch.bfloat16), (2048, torch.float32))
# grouped expert matmul: capacity C of a decode tick (8 slots), of
# 128-, 1100- and 2048-token prompts (32, 275, 512: ceil(S*8*1.25/40),
# at least 8), each for the gate/up (1536 -> 512) and down (512 -> 1536)
# products
GMM_CAPS = (8, 32, 275, 512)
GMM_DIMS = ((1536, 512), (512, 1536))
# the kernels whose bf16 path runs on the tensor cores (wgmma fed by TMA),
# with the name their bf16 kernels carry
TC_KERNELS = {"moe_gmm": "gmm_wgmma", "flash_attention": "flash_fwd_wgmma"}


class SmokeFailure(AssertionError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def layers(sig):
    """(H, Cin, Cout) of each conv layer of an operator signature."""
    n_layers, channels, _dense, size = sig
    out, h, cin = [], size, 3
    for _ in range(n_layers):
        out.append((h, cin, channels))
        h, cin = -(-h // 2), channels
    return out


def valid_taps(h, stride=2):
    """Kernel taps along one axis that land inside the image, summed over
    the outputs: the taps on SAME padding multiply zeros and are skipped."""
    ho, top, _ = ref.same_pad(h, stride)
    return sum(0 <= o * stride - top + k < h
               for o in range(ho) for k in range(3))


def conv_bound(n, h, cin, cout):
    """Least time (ms) of one conv_scorer call and what sets it: bytes
    (x, w, b read once, out written once) over the memory rate, or fp32
    operations (2*Cin per in-bounds tap of each output) over the fp32
    peak."""
    ho = -(-h // 2)
    flops = 2.0 * cin * cout * n * valid_taps(h) ** 2
    nbytes = 4.0 * (n * h * h * cin + 9 * cin * cout + cout +
                    n * ho * ho * cout)
    t_ops, t_bytes = flops / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes", flops, nbytes)


def time_ms(fn, iters: int = 20, warmup: int = 3,
            lead_cycles: int = 0) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back launches,
    from CUDA events after a warm-up. With ``lead_cycles`` the card first
    spins that long, so that the host has queued every launch before the
    first one runs: the events then time the device alone, without the
    host's cost of each call, which a small kernel's device time is
    below."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if lead_cycles:
        torch.cuda._sleep(lead_cycles)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def free_memory() -> None:
    """Collect reference cycles (a served engine's wrapped methods refer
    back to it, and so to its model and caches) and return the cached
    blocks, so that a phase's peak memory is its own."""
    gc.collect()
    torch.cuda.empty_cache()


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


# -- phase 1: build -----------------------------------------------------------

def demangle(names):
    """C++ names of mangled kernel names, by ``c++filt`` where the host
    has it; the anonymous namespace is left out."""
    names = list(names)
    try:
        out = subprocess.run(["c++filt"], input="\n".join(names),
                             capture_output=True, text=True, check=True,
                             timeout=60).stdout.splitlines()
    except (OSError, subprocess.SubprocessError):
        return dict(zip(names, names))
    return {n: d.replace("(anonymous namespace)::", "")
            for n, d in zip(names, out)}


def build_phase() -> None:
    """Every kernel's nvcc build, all started together (one process per
    source); then ptxas's registers, spills and static shared memory for
    each kernel, and the tensor-core instructions (``HGMMA``) in the SASS
    of each kernel of the two redesigned sources: every bf16 kernel there
    must hold some, the float32 ones run on the CUDA cores."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        paths = dict(zip(KERNELS, pool.map(build.build, KERNELS)))
    print(f"build: {len(KERNELS)} kernels in parallel in "
          f"{time.perf_counter() - t0:.3f} s")
    for name, path in paths.items():
        print(f"build: {path.relative_to(ROOT)}")
        res = build.resources(build.logs.get(name, ""))
        short = demangle(r["kernel"] for r in res)
        for r in res:
            print(f"  ptxas {short[r['kernel']]}: {r['registers']} "
                  f"registers, {r['spill_stores']} B spill stores, "
                  f"{r['spill_loads']} B spill loads, {r['smem']} B static "
                  f"smem")
    for name, tag in TC_KERNELS.items():
        counts = build.sass_counts(name)
        short = demangle(counts)
        tc = {k: v for k, v in counts.items() if tag in k}
        print(f"sass {name}: " + "; ".join(
            f"{short[k]} HGMMA {v}" for k, v in counts.items()))
        check(bool(tc) and all(tc.values()),
              f"{name}: a bf16 kernel without HGMMA instructions {tc}")


# -- phase 2: the kernel against its plain version ----------------------------

def kernel_phase(device) -> dict:
    """Every conv layer shape of the reduced family at N = 1024: the
    kernel against ``ref.conv_scorer`` (<= 1e-4), then timed beside the
    plain version and one cuDNN call (conv + bias, TF32 off: the
    yardstick, never called by the port), in turns."""
    shapes = sorted({s for sig in FAMILY for s in layers(sig)},
                    key=lambda s: (-s[0], s[1], s[2]))
    rows = {}
    for h, cin, cout in shapes:
        rng = np.random.default_rng(h * 100 + cin + cout)
        x = torch.from_numpy(rng.uniform(
            size=(N, h, h, cin)).astype(np.float32)).to(device)
        w = torch.from_numpy((rng.standard_normal((3, 3, cin, cout)) /
                              math.sqrt(9 * cin)).astype(np.float32)).to(device)
        b = torch.from_numpy(rng.standard_normal(cout).astype(
            np.float32)).to(device)
        got = cs.conv_scorer(x, w, b)
        want = ref.conv_scorer(x, w, b)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        check(math.isfinite(err) and err <= KERNEL_TOL,
              f"conv_scorer H{h} {cin}->{cout}: max |err| {err} > "
              f"{KERNEL_TOL}")
        _, top, bottom = ref.same_pad(h, 2)
        xp = F.pad(x.permute(0, 3, 1, 2), (top, bottom) * 2  # H == W
                   ).contiguous(memory_format=torch.channels_last)
        w_oihw = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)

        def library():
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                return F.conv2d(xp, w_oihw, b, stride=2)

        def kernel():
            return cs.conv_scorer(x, w, b)

        def plain():
            return ref.conv_scorer(x, w, b)

        lib_out = library()
        check(float((lib_out.permute(0, 2, 3, 1).relu() - want).abs().max())
              <= KERNEL_TOL, "cuDNN yardstick disagrees with the plain version")
        t = {"plain": [], "kernel": [], "library": []}
        for name in ("plain", "kernel", "library", "library", "kernel",
                     "plain"):
            t[name].append(time_ms({"plain": plain, "kernel": kernel,
                                    "library": library}[name]))
        bound, by, flops, nbytes = conv_bound(N, h, cin, cout)
        row = {"max_abs_err": err, "ms": float(np.mean(t["kernel"])),
               "plain_ms": float(np.mean(t["plain"])),
               "library_ms": float(np.mean(t["library"])),
               "bound_ms": bound, "bound_by": by, "flops": flops,
               "bytes": nbytes}
        rows[(h, cin, cout)] = row
        print(f"kernel conv_scorer N={N} H={h} {cin}->{cout}: "
              f"max|err| {err:.3e}  kernel {row['ms']:.4f} ms  "
              f"plain {row['plain_ms']:.4f} ms  "
              f"cuDNN {row['library_ms']:.4f} ms  "
              f"bound {bound:.4f} ms ({by})  "
              f"share of bound {bound / row['ms']:.3f}")
        del x, w, b, got, want, xp, w_oihw, lib_out
    torch.cuda.empty_cache()
    return rows


# -- phase 3: the scoring runtime against the plain forward -------------------

def operator_phase(device) -> None:
    sig = MAIN_OP
    arch = ops.OperatorArch("op_L5c32s100_smoke", *sig)
    params = ops.init_operator(arch, torch.Generator().manual_seed(0), device)
    crops = np.random.default_rng(1).uniform(
        size=(1500, sig[3], sig[3], 3)).astype(np.float32)
    rt = OperatorRuntime(device=device)
    p, c = rt.score_crops(params, arch, crops)
    ep, ec = ops.score_frames(params, crops)
    err = max(float(np.abs(p - ep).max()), float(np.abs(c - ec).max()))
    check(np.isfinite(p).all() and np.isfinite(c).all(),
          "runtime scores are not finite")
    check(err <= SCORE_TOL, f"runtime vs plain forward: {err} > {SCORE_TOL}")
    print(f"operator op_L5c32s100: {len(crops)} frames, runtime vs plain "
          f"forward max|diff| {err:.3e} (dispatches {rt.dispatch_stats()})")
    # F2: the same 20 frames through the small (32-row), bucketed (64-row)
    # and superbatch (2 x 64-row) layers
    few = crops[:20]
    small = OperatorRuntime(device=device, small_flops=float("inf"))
    bucketed = OperatorRuntime(device=device, small_flops=0)
    ps, cs_ = small.score_crops(params, arch, few)
    pb, cb = bucketed.score_crops(params, arch, few)

    class Trained:
        def __init__(self):
            self.arch, self.params = arch, params

    class Bank:
        def crops(self, idxs, region, size):
            return crops[np.asarray(idxs)]

    (pg, cg), _ = bucketed.score_demands(
        [(Trained(), Bank(), np.arange(20)),
         (Trained(), Bank(), np.arange(20, 40))], group_max=2)
    check(small.small_calls == 1 and bucketed.super_calls == 1,
          "layer selection")
    rows = {"small": [s[0] for v in small.shape_vocab().values() for s in v],
            "bucketed": [s[:-3] for v in bucketed.shape_vocab().values()
                         for s in v]}
    check(rows == {"small": [32], "bucketed": [(2, 64), (64,)]},
          f"dispatch shapes {rows}")
    d_sb = max(float(np.abs(ps - pb).max()), float(np.abs(cs_ - cb).max()))
    d_gb = max(float(np.abs(pg - pb).max()), float(np.abs(cg - cb).max()))
    print(f"F2 rows {rows}: small vs bucketed max|diff| {d_sb:.3e}; "
          f"superbatch vs bucketed max|diff| {d_gb:.3e}")
    check(d_sb <= SCORE_TOL and d_gb <= SCORE_TOL, "dispatch layers disagree")


# -- phase 4: the main path ----------------------------------------------------

def main_path(device, hours: float = HOURS, max_passes: int = 12,
              trace: bool = False) -> dict:
    """One Retrieval query end to end through the port's entry points.
    ``trace`` runs it under the CUDA profiler to read the card's busy
    time; tracing slows the host, so wall times come from untraced runs.
    """
    wall = {"train": 0.0, "score": 0.0, "crops": 0.0}

    def timed(fn, key):
        def wrapper(*args, **kwargs):
            t = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                wall[key] += time.perf_counter() - t
        return wrapper

    t0 = time.perf_counter()
    video = Video(corpus(hours=hours)["Banff"])
    store = lm.build_landmarks(video, 30, YOLO_V3)
    env = make_env(video, Query("retrieval", "bus"), store)
    t_env = time.perf_counter() - t0
    rt = OperatorRuntime() if device.type == "cuda" else \
        OperatorRuntime(device=device)
    check(rt.device.type == device.type, f"runtime on {rt.device}")
    prev = set_runtime(rt)
    # host time of training, and of rendering + cropping frames (inside
    # both training and scoring)
    env.trainer.train = timed(env.trainer.train, "train")
    env.bank.crops = timed(env.bank.crops, "crops")
    ex = RetrievalExecutor(env, full_family=False)
    first_score = []

    def score(d):
        if not first_score:
            first_score.append(time.perf_counter())
        return ex.session.score(d.trained, d.idxs)

    # the card's busy time: kernel and copy time traced by CUPTI
    profiler = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) \
        if trace else contextlib.nullcontext()
    cs.conv_scorer.launches = 0
    t1 = time.perf_counter()
    try:
        with profiler:
            prog = drive(ex.steps(max_passes), ex.session,
                         score=timed(score, "score"))
            if device.type == "cuda":
                torch.cuda.synchronize()
    finally:
        set_runtime(prev)
    t_end = time.perf_counter()
    launches = cs.conv_scorer.launches
    busy = device_busy(profiler) if trace else {}

    vs = [v for _, v in prog.points]
    ts = [t for t, _ in prog.points]
    t50, t90, t99 = (prog.time_to(f) for f in (0.5, 0.9, 0.99))
    check(prog.done_t is not None and math.isfinite(prog.done_t),
          "query did not finish")
    check(all(a <= b + 1e-9 for a, b in zip(ts, ts[1:])), "time monotone")
    check(all(a <= b for a, b in zip(vs, vs[1:])), "retrieval monotone")
    check(vs and vs[-1] >= 0.99, "query returned < 99% of positives")
    check(bool(prog.op_switches), "no operator shipped")
    check(t50 is not None and t99 is not None and t50 < 0.55 * t99,
          "positives did not arrive online (t50 >= 0.55 t99)")
    if device.type == "cuda":
        check(launches > 0, "the main path launched no conv_scorer kernel")
    video_s = env.n_frames / video.spec.fps
    boot = (first_score[0] if first_score else t_end) - t1
    out = {
        "frames": env.n_frames, "positives": env.n_positives,
        "time_to_0.5": t50, "time_to_0.9": t90, "time_to_0.99": t99,
        "done_t": prog.done_t, "x_realtime": video_s / prog.done_t,
        "bytes_up": prog.bytes_up,
        "operators": [n for _, n in prog.op_switches],
        "wall_env_s": t_env, "wall_bootstrap_s": boot,
        "wall_passes_s": t_end - t1 - boot, "wall_query_s": t_end - t1,
        "wall_train_s": wall["train"], "wall_score_s": wall["score"],
        "frames_scored": rt.frames_scored,
        "frames_per_score_s": rt.frames_scored / max(wall["score"], 1e-9),
        "wall_crops_s": wall["crops"],
        "dispatch": rt.dispatch_stats(), "conv_scorer_launches": launches,
        **busy,
    }
    label = "traced query" if trace else "query"
    print(f"{label} (simulated): {env.n_frames} frames, {env.n_positives} "
          f"positives; time_to 0.5/0.9/0.99 = {t50:.3f}/{t90:.3f}/"
          f"{t99:.3f} s; done_t {prog.done_t:.3f} s = "
          f"{out['x_realtime']:.2f}x video realtime; bytes_up "
          f"{prog.bytes_up:.0f}; operators {out['operators']}")
    print(f"{label} (card, host wall): env {t_env:.2f} s; query "
          f"{t_end - t1:.2f} s = bootstrap {boot:.2f} s + passes "
          f"{out['wall_passes_s']:.2f} s, of which training "
          f"{wall['train']:.2f} s and scoring {wall['score']:.2f} s; "
          f"{rt.frames_scored} frames scored at "
          f"{out['frames_per_score_s']:.1f} frames/s of scoring wall time; "
          f"dispatch {rt.dispatch_stats()}; conv_scorer launches {launches}")
    print(f"{label} (card): rendering + crops {wall['crops']:.2f} s of "
          f"host wall")
    if trace:
        print(f"traced query (card): device busy "
              + (f"{busy['device_busy_s']:.3f} s (conv_scorer "
                 f"{busy['conv_scorer_device_s']:.3f} s), top "
                 f"{busy['top_kernels']}" if busy else "not measured"))
    return out


def device_busy(prof, kernels=(("conv_scorer", "conv3x3_bias_relu"),)
                ) -> dict:
    """Device time traced during a run: all kernels and copies, each
    named kernel's share (``(label, name substring)`` pairs), and the
    largest items. Empty when the trace holds no device time."""
    rows = []
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0)
        rows.append((float(us) * 1e-6, e.key, e.count))
    total = sum(r[0] for r in rows)
    if total <= 0:
        return {}
    rows.sort(reverse=True)
    out = {"device_busy_s": total}
    for label, sub in kernels:
        out[f"{label}_device_s"] = sum(r[0] for r in rows if sub in r[1])
    out["top_kernels"] = [(k[:60], round(t, 4), n) for t, k, n in rows[:8]]
    return out


# -- phase 5: the LM kernels at the served shapes ---------------------------

def _randn(shape, dtype, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(dtype)


def _in_turns(kernel, plain, library, iters):
    """Mean device ms of each, run plain, kernel, library, library,
    kernel, plain, with the launches queued ahead (``LEAD_CYCLES``); and
    the kernel's ms per call when each call waits for the host
    (``call``)."""
    fns = {"plain": plain, "kernel": kernel, "library": library}
    t = {n: [] for n in fns}
    for n in ("plain", "kernel", "library", "library", "kernel", "plain"):
        t[n].append(time_ms(fns[n], iters=iters, warmup=2,
                            lead_cycles=LEAD_CYCLES))
    out = {k: float(np.mean(v)) for k, v in t.items()}
    out["call"] = time_ms(kernel, iters=iters, warmup=0)
    return out


def _bound(flops, nbytes, dtype):
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    t_ops, t_bytes = flops / peak, nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def _kept_pairs(sq, sk, window, q_offset=0):
    """(q, k) pairs that causal attention with this window keeps."""
    pos = np.arange(sq, dtype=np.int64) + q_offset
    lo = np.maximum(0, pos - window + 1) if window else np.zeros_like(pos)
    return int(np.sum(np.minimum(pos, sk - 1) - lo + 1))


def _row(name, what, err, t, bound, by):
    row = {"max_abs_err": err, "ms": t["kernel"], "plain_ms": t["plain"],
           "library_ms": t["library"], "bound_ms": bound, "bound_by": by,
           "call_ms": t["call"]}
    print(f"kernel {name} {what}: max|err| {err:.3e}  kernel "
          f"{row['ms']:.4f} ms (per call with the host "
          f"{row['call_ms']:.4f} ms)  plain {row['plain_ms']:.4f} ms  library "
          f"{row['library_ms']:.4f} ms  bound {bound:.4f} ms ({by})  "
          f"share of bound {bound / row['ms']:.3f}")
    return row


def lm_kernel_phase(device, arch: str = LM_ARCH, rms_shapes=RMS_SHAPES,
                    flash_shapes=FLASH_SHAPES) -> dict:
    """Each attention-model kernel against its plain version at the
    shapes serving ``arch`` gives it (h2o-danube-1.8b: d 2560, 32 query
    heads over 8 kv heads of dim 80, window 4096; granite-moe-3b-a800m:
    d 1536, 24 over 8 of dim 64, no window; 8 slots of 4096 ring rows),
    timed beside the plain version and one PyTorch library call (the
    yardstick, never called by the port). Returns rows keyed (kernel,
    label); granite's labels name its heads."""
    cfg = get_config(arch)
    d, H, KV, D = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                   cfg.resolved_head_dim)
    W = cfg.pattern[0].window
    heads = "" if arch == LM_ARCH else f" {H}/{KV}x{D}"
    rows = {}
    for rows_, dt in rms_shapes:
        x = _randn((rows_, d), dt, device, rows_) * 3
        scale = 1 + 0.1 * _randn((d,), torch.float32, device, 1)
        got = rms.rmsnorm(x, scale)
        err = float((got.float() - ref.rmsnorm(x, scale).float()).abs().max())
        check(math.isfinite(err) and err <= LM_TOL[dt],
              f"rmsnorm {rows_}x{d} {dt}: max |err| {err}")
        lib_w = scale.to(dt)
        t = _in_turns(lambda: rms.rmsnorm(x, scale),
                      lambda: ref.rmsnorm(x, scale),
                      lambda: F.rms_norm(x, (d,), lib_w, 1e-6), iters=50)
        size = x.element_size()
        bound, by = _bound(3.0 * x.numel(), 2 * x.numel() * size + 4 * d,
                           dt)
        label = f"{rows_}x{d} {str(dt)[6:]}"
        rows[("rmsnorm", label)] = _row("rmsnorm", label, err, t, bound, by)

    for S, dt in flash_shapes:
        q = _randn((1, S, H, D), dt, device, S)
        k = _randn((1, S, KV, D), dt, device, S + 1)
        v = _randn((1, S, KV, D), dt, device, S + 2)
        got = fa.flash_attention(q, k, v, causal=True, window=W)
        want = ref.attention(q, k, v, causal=True, window=W)
        err = float((got.float() - want.float()).abs().max())
        check(math.isfinite(err) and err <= LM_TOL[dt],
              f"flash attention S={S} {dt}: max |err| {err}")
        del got, want
        qt = q.transpose(1, 2)
        kt = ref.expand_kv(k, H).transpose(1, 2)
        vt = ref.expand_kv(v, H).transpose(1, 2)
        pos = torch.arange(S, device=device)
        band = None if W is None or S <= W else \
            (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - W)

        def library():
            if band is None:
                return F.scaled_dot_product_attention(qt, kt, vt,
                                                      is_causal=True)
            return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band)

        t = _in_turns(lambda: fa.flash_attention(q, k, v, causal=True,
                                                 window=W),
                      lambda: ref.attention(q, k, v, causal=True, window=W),
                      library, iters=3 if S > 4096 else 10)
        pairs = _kept_pairs(S, S, W)
        bound, by = _bound(4.0 * D * H * pairs,
                           (2 * q.numel() + 2 * k.numel()) * q.element_size(),
                           dt)
        label = f"B=1 S={S}{heads} {str(dt)[6:]}"
        rows[("flash_attention", label)] = _row("flash_attention", label,
                                                err, t, bound, by)
        del q, k, v, qt, kt, vt, band
        torch.cuda.empty_cache()

    B, S = 8, 4096
    pos = np.random.default_rng(0).integers(0, S, size=B)
    pos[-1] = S + 904                      # one slot past the ring's wrap
    tpos = torch.tensor(pos, dtype=torch.int32, device=device)
    n_valid = np.minimum(pos + 1, S)
    for dt in (torch.bfloat16, torch.float32):
        q = _randn((B, H, D), dt, device, 7)
        k = _randn((B, S, KV, D), dt, device, 8)
        v = _randn((B, S, KV, D), dt, device, 9)
        got = da.decode_attention(q, k, v, tpos)
        err = float((got.float() - ref.decode_attention(q, k, v, tpos).float()
                     ).abs().max())
        check(math.isfinite(err) and err <= LM_TOL[dt],
              f"decode attention {dt}: max |err| {err}")
        qt = q[:, :, None]
        kt = ref.expand_kv(k, H).transpose(1, 2)
        vt = ref.expand_kv(v, H).transpose(1, 2)
        rows_ = torch.arange(S, device=device)[None, :]
        valid = ((rows_ <= tpos[:, None].long()) |
                 (tpos[:, None].long() >= S))[:, None, None, :]
        t = _in_turns(lambda: da.decode_attention(q, k, v, tpos),
                      lambda: ref.decode_attention(q, k, v, tpos),
                      lambda: F.scaled_dot_product_attention(
                          qt, kt, vt, attn_mask=valid), iters=50)
        size = q.element_size()
        nbytes = (2 * int(n_valid.sum()) * KV * D + 2 * q.numel()) * size \
            + 4 * B
        bound, by = _bound(4.0 * D * H * int(n_valid.sum()), nbytes, dt)
        label = f"B=8 S=4096{heads} pos {pos.tolist()} {str(dt)[6:]}"
        rows[("decode_attention", label)] = _row("decode_attention", label,
                                                 err, t, bound, by)
        del q, k, v, kt, vt
    torch.cuda.empty_cache()
    return rows


def moe_kernel_phase(device) -> dict:
    """The grouped expert matmul against its plain version at the shapes
    serving granite-moe-3b-a800m gives it (40 experts; capacity 8 in a
    decode tick, 32 to 512 in a prefill, one ragged; 1536 -> 512 for
    the gate and up products, 512 -> 1536 for the down product), in
    bfloat16 and float32, timed beside the plain version and one
    ``torch.bmm`` (the yardstick, never called by the port). x has unit
    entries, as a normed token does, and w the init's 1/sqrt(fan-in)."""
    E = get_config(MOE_ARCH).num_experts
    rows = {}
    for C in GMM_CAPS:
        for d, f in GMM_DIMS:
            for dt in (torch.bfloat16, torch.float32):
                x = _randn((E, C, d), dt, device, C + d)
                w = (_randn((E, d, f), torch.float32, device, C + d + 1)
                     / d ** 0.5).to(dt)
                got = gmm.moe_gmm(x, w)
                err = float((got.float() - ref.moe_gmm(x, w).float())
                            .abs().max())
                check(math.isfinite(err) and err <= GMM_TOL[dt],
                      f"moe_gmm E={E} C={C} {d}->{f} {dt}: max |err| {err}")
                check(torch.equal(gmm.moe_gmm(x[:, :1].contiguous(), w),
                                  got[:, :1]),
                      f"moe_gmm C={C} {d}->{f} {dt}: a row's result "
                      "depends on C")
                t = _in_turns(lambda: gmm.moe_gmm(x, w),
                              lambda: ref.moe_gmm(x, w),
                              lambda: torch.bmm(x, w), iters=20)
                bound, by = _bound(2.0 * E * C * d * f,
                                   (x.numel() + w.numel() + E * C * f)
                                   * x.element_size(), dt)
                label = f"E={E} C={C} {d}->{f} {str(dt)[6:]}"
                rows[("moe_gmm", label)] = _row("moe_gmm", label, err, t,
                                                bound, by)
                del x, w, got
    torch.cuda.empty_cache()
    return rows


# -- phase 6: the whole model, kernel path against plain path ----------------

@contextlib.contextmanager
def plain_lm_path():
    """The model with its four dispatch functions swapped for their
    plain PyTorch versions on the card: the reference of the parity
    phase. The port itself never sends a CUDA tensor to a plain version;
    this swap exists only here."""
    names = ("rmsnorm", "attention", "decode_attention", "moe_gmm")
    saved = [getattr(kops, n) for n in names]
    for n in names:
        setattr(kops, n, getattr(ref, n))
    try:
        yield
    finally:
        for n, fn in zip(names, saved):
            setattr(kops, n, fn)


def lm_launches():
    return {"rmsnorm": rms.rmsnorm.launches,
            "flash_attention": fa.flash_attention.launches,
            "decode_attention": da.decode_attention.launches,
            "moe_gmm": gmm.moe_gmm.launches}


@contextlib.contextmanager
def recorded_routes(log, label):
    """Append ``(label[0], top-k experts)`` to ``log`` at every MoE
    layer's routing, in call order."""
    real = moe.route

    def route(*args, **kwargs):
        out = real(*args, **kwargs)
        log.append((label[0], out[3].clone()))
        return out

    moe.route = route
    try:
        yield
    finally:
        moe.route = real


def _serve_both(model, prompts, max_new):
    """Prefill logits and caches and the engine's greedy tokens of every
    prompt, on the kernel path and on the plain path; the plain run
    launches no kernel. For an MoE model, also every routing of both
    paths (``recorded_routes``), labelled by request: the standalone
    prefills ("prefill", r), the engine's prefills ("again", r), which
    repeat them, and its ticks ("tick", {slot: r})."""
    out = {}
    is_moe = model.cfg.num_experts > 0
    for path in ("kernel", "plain"):
        ctx = plain_lm_path() if path == "plain" else contextlib.nullcontext()
        log, label = [], [None]
        before = lm_launches()
        with ctx, recorded_routes(log, label):
            pre = []
            for r, p in enumerate(prompts):
                label[0] = ("prefill", r)
                pre.append(tf.prefill(model, torch.tensor(
                    p[None].astype(np.int64), device=model.device)))
            tokens = None
            if max_new:
                eng = ServeEngine(model, slots=len(prompts), cache_len=4096)
                rids = [eng.submit(p, max_new) for p in prompts]
                index = {rid: r for r, rid in enumerate(rids)}
                prefill_into, tick = eng._prefill_into, eng._tick

                def labelled_prefill(slot, req):
                    label[0] = ("again", index[req.rid])
                    prefill_into(slot, req)

                def labelled_tick(results):
                    label[0] = ("tick", {s: index[q.rid] for s, q in
                                         eng.active.items() if q is not None})
                    tick(results)

                eng._prefill_into, eng._tick = labelled_prefill, labelled_tick
                res = eng.run()
                tokens = [res[r] for r in rids]
        moved = {k: lm_launches()[k] - v for k, v in before.items()}
        used = ("rmsnorm", "flash_attention") + (
            ("decode_attention",) if max_new else ()) + (
            ("moe_gmm",) if is_moe else ())
        check(all(moved[k] for k in used) if path == "kernel" else
              not any(moved.values()), f"{path} path launches {moved}")
        out[path] = (torch.stack([lg[0, -1] for lg, _ in pre]).float(),
                     [c for _, c in pre], tokens, log)
    return out


def route_diffs(log_a, log_b, n_requests):
    """Per request, the (token, layer) top-k expert sets that differ
    between two runs' routing logs, and the number compared; the
    engine's repeated prefills are left out."""
    check(len(log_a) == len(log_b) and
          all(a[0] == b[0] for a, b in zip(log_a, log_b)),
          "the two paths routed different forwards")
    diff, total = [0] * n_requests, [0] * n_requests
    for (lab, a), (_, b) in zip(log_a, log_b):
        if lab[0] == "again":
            continue
        rows = ((a.sort(dim=-1).values != b.sort(dim=-1).values)
                .any(dim=-1).cpu().numpy())
        owners = [lab[1]] * len(rows) if lab[0] == "prefill" else \
            [lab[1].get(slot) for slot in range(len(rows))]
        for owner, differs in zip(owners, rows):
            if owner is not None:
                diff[owner] += int(differs)
                total[owner] += 1
    return diff, total


def unit_scores(model) -> None:
    """Scale wq and wk to their true fan-in, 1/sqrt(d_model), in place.

    ``repro/models/layers.py::param`` takes the fan-in of a 3-D weight
    from its second-to-last axis, the (padded) head count: at
    h2o-danube-1.8b's width wq's entries have std 1/sqrt(32) and wk's
    1/sqrt(8) (granite-moe-3b-a800m: its 24 query heads padded to 32, and
    8), so a score q.k /
    sqrt(80) has a std near 159 and the softmax is all but one-hot. A
    perturbation at rounding level then grows from layer to layer (the
    parity phase prints how fast), and no two computations of the model
    that are not bit-identical agree after 24 layers. With this scaling
    the scores have unit variance, as in a trained model."""
    cfg = model.cfg
    with torch.no_grad():
        for b in model.blocks:
            b.mixer.wq.mul_((attention.padded_heads(cfg.num_heads)
                             / cfg.d_model) ** 0.5)
            b.mixer.wk.mul_((cfg.num_kv_heads / cfg.d_model) ** 0.5)


def lm_parity_phase(device) -> dict:
    """h2o-danube-1.8b at full width and depth, random weights from one
    CUDA generator seed, kernel path against plain path. At the JAX
    package's init scale (float32) the per-layer gap of the caches is
    printed: it grows with depth. With unit-variance scores
    (``unit_scores``): in float32 the prefill logits are within 1e-3
    and the greedy tokens identical; as published (bfloat16) the first
    token of every request agrees."""
    out = {}
    for cdt, scale in (("float32", "jax"), ("float32", "unit"),
                       ("bfloat16", "unit")):
        cfg = get_config(LM_ARCH).scaled(compute_dtype=cdt)
        prompts = [np.random.default_rng(s).integers(0, cfg.vocab_size, n)
                   for s, n in enumerate((5, 77, 1031, 2047))]
        t0 = time.perf_counter()
        model = tf.init_model(cfg, torch.Generator(device=device)
                              .manual_seed(0), device)
        t_init = time.perf_counter() - t0
        if scale == "unit":
            unit_scores(model)
        both = _serve_both(model, prompts, max_new=8 if scale == "unit"
                           else 0)
        (lk, ck, tk, _), (lp, cp, tp, _) = both["kernel"], both["plain"]
        check(bool(torch.isfinite(lk).all()) and
              lk.shape == (4, cfg.vocab_size),
              f"{cdt} prefill logits {tuple(lk.shape)}")
        dmax = float((lk - lp).abs().max())
        rel = dmax / float(lp.abs().max())
        # the longest prompt's k cache, layer by layer
        gap = [float((a["k"].float() - b["k"].float()).abs().max())
               for a, b in zip(ck[-1], cp[-1])]
        row = {"max_abs_dlogit": dmax, "rel_dlogit": rel,
               "max_abs_dk_by_layer": gap}
        line = (f"parity {LM_ARCH} {cdt}, {scale} scores ({cfg.num_layers}L "
                f"d{cfg.d_model}, init {t_init:.2f} s): prefill "
                f"max|dlogit| {dmax:.3e}, / max|logit| {rel:.3e}; "
                f"max|dk| by layer " + " ".join(f"{g:.1e}" for g in gap))
        if tk is not None:
            agree = sum(a == b for x, y in zip(tk, tp) for a, b in zip(x, y))
            row["token_agreement"] = agree / sum(len(x) for x in tp)
            line += (f"; greedy tokens agree {row['token_agreement']:.4f}; "
                     f"kernel {tk[1]} plain {tp[1]}")
        print(line)
        if scale == "unit":
            if cdt == "float32":
                check(dmax <= LOGIT_TOL, f"float32 logits differ by {dmax}")
                check(tk == tp, "float32 greedy tokens differ")
            check(all(a[0] == b[0] for a, b in zip(tk, tp)),
                  f"{cdt}: a first token differs")
        out[f"{cdt}_{scale}"] = row
        del model, both, ck, cp
        free_memory()
    return out


def moe_parity_phase(device) -> dict:
    """granite-moe-3b-a800m at full width and depth, random weights from
    one CUDA generator seed with unit-variance scores (F3), kernel path
    against plain path, float32 then bfloat16. A near-tie at the k-th
    expert can flip a route between two computations that differ by
    rounding, which changes a token's output by O(gate weight); so the
    phase counts the (token, layer) top-8 expert sets that differ. In
    float32 at most ``ROUTE_LIMIT`` of them may, and the requests whose
    routes all agree keep their prefill logits within 1e-3 and their
    greedy tokens identical. In bfloat16 it reports."""
    out = {}
    for cdt in ("float32", "bfloat16"):
        cfg = get_config(MOE_ARCH).scaled(compute_dtype=cdt)
        prompts = [np.random.default_rng(s).integers(0, cfg.vocab_size, n)
                   for s, n in enumerate((5, 77, 1031, 2047))]
        t0 = time.perf_counter()
        model = tf.init_model(cfg, torch.Generator(device=device)
                              .manual_seed(0), device)
        t_init = time.perf_counter() - t0
        unit_scores(model)
        both = _serve_both(model, prompts, max_new=8)
        (lk, _, tk, rk), (lp, _, tp, rp) = both["kernel"], both["plain"]
        check(bool(torch.isfinite(lk).all()) and
              lk.shape == (4, cfg.vocab_size),
              f"{cdt} prefill logits {tuple(lk.shape)}")
        diff, total = route_diffs(rk, rp, len(prompts))
        share = sum(diff) / sum(total)
        dlogit = (lk - lp).abs().max(dim=-1).values.tolist()
        agree = [sum(a == b for a, b in zip(x, y)) / len(y)
                 for x, y in zip(tk, tp)]
        clean = [r for r in range(len(prompts)) if diff[r] == 0]
        row = {"max_abs_dlogit": max(dlogit),
               "rel_dlogit": max(dlogit) / float(lp.abs().max()),
               "dlogit_by_request": dlogit, "token_agreement_by_request":
               agree, "routes_compared": sum(total),
               "routes_differing": sum(diff), "route_share": share,
               "routes_differing_by_request": diff}
        print(f"parity {MOE_ARCH} {cdt}, unit scores ({cfg.num_layers}L "
              f"d{cfg.d_model}, {cfg.num_experts} experts top-"
              f"{cfg.top_k}, init {t_init:.2f} s): prefill max|dlogit| by "
              f"request " + " ".join(f"{x:.3e}" for x in dlogit) +
              f", / max|logit| {row['rel_dlogit']:.3e}; greedy tokens "
              f"agree by request {agree}; top-{cfg.top_k} expert sets "
              f"differing {sum(diff)} of {sum(total)} (token, layer) "
              f"routes = {share:.2e}, by request {diff}; kernel {tk[1]} "
              f"plain {tp[1]}")
        if cdt == "float32":
            check(share <= ROUTE_LIMIT, f"float32: {share:.2e} of the "
                  f"routes differ (limit {ROUTE_LIMIT})")
            for r in clean:
                check(dlogit[r] <= LOGIT_TOL,
                      f"float32 logits of request {r} differ by "
                      f"{dlogit[r]}")
                check(tk[r] == tp[r], f"float32 greedy tokens of request "
                      f"{r} differ")
        out[cdt] = row
        del model, both
        free_memory()
    return out


# -- phase 7: the LM main path, serving a model ------------------------------

def serve_phase(device, trace: bool = False, arch: str = LM_ARCH) -> dict:
    """16 requests submitted at once to ``ServeEngine`` (8 slots, 4096
    ring rows) serving the published ``arch`` (h2o-danube-1.8b or
    granite-moe-3b-a800m, bfloat16) with random weights: prompts of
    128-2048 tokens, 64 greedy tokens each. Host wall of each prefill
    and each decode tick (each ends in the sampler's copy to the host,
    so the card has finished), time to first token per request, and the
    LM kernels' launches: the model's kernels all launched, the grouped
    expert matmul 3 times per MoE layer per forward."""
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    model = tf.init_model(cfg, torch.Generator(device=device).manual_seed(0),
                          device)
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 2049, size=16)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lens]
    eng = ServeEngine(model, slots=8, cache_len=4096)
    wall = {"prefill": 0.0, "decode": 0.0, "ticks": 0, "decoded": 0}
    first = {}
    prefill_into, tick = eng._prefill_into, eng._tick

    def timed_prefill(slot, req):
        t = time.perf_counter()
        prefill_into(slot, req)
        now = time.perf_counter()
        wall["prefill"] += now - t
        first[req.rid] = now - t0

    def timed_tick(results):
        n = sum(r is not None for r in eng.active.values())
        t = time.perf_counter()
        tick(results)
        wall["decode"] += time.perf_counter() - t
        wall["ticks"] += 1
        wall["decoded"] += n

    eng._prefill_into, eng._tick = timed_prefill, timed_tick
    rids = [eng.submit(p, max_new=64) for p in prompts]
    profiler = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA]) \
        if trace else contextlib.nullcontext()
    for f in (rms.rmsnorm, fa.flash_attention, da.decode_attention,
              gmm.moe_gmm):
        f.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profiler:
        res = eng.run()
        torch.cuda.synchronize()
    t_wall = time.perf_counter() - t0
    launches = lm_launches()
    check(sorted(res) == sorted(rids) and
          all(len(res[r]) == 64 for r in rids), "not every request finished")
    check(all(0 <= t < cfg.vocab_size for r in rids for t in res[r]),
          "a token outside the vocabulary")
    n_moe = sum(cfg.pattern[i % len(cfg.pattern)].ffn == "moe"
                for i in range(cfg.num_layers))
    forwards = len(first) + wall["ticks"]
    check(all(v for k, v in launches.items() if k != "moe_gmm") and
          launches["moe_gmm"] == 3 * n_moe * forwards,
          f"LM kernel launches {launches} over {forwards} forwards of "
          f"{n_moe} MoE layers")
    ttft = np.array([first[r] for r in rids])
    out = {
        "requests": len(rids), "prompt_tokens": int(lens.sum()),
        "new_tokens": sum(len(res[r]) for r in rids), "wall_s": t_wall,
        "prefill_s": wall["prefill"], "decode_s": wall["decode"],
        "ticks": wall["ticks"], "ms_per_tick": 1e3 * wall["decode"] /
        wall["ticks"], "prefill_tok_per_s": float(lens.sum()) /
        wall["prefill"],
        "decode_tok_per_s": wall["decoded"] / wall["decode"],
        "ttft_p50_s": float(np.median(ttft)), "ttft_max_s": float(ttft.max()),
        "launches": launches,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
    }
    if trace:
        out.update(device_busy(profiler, (
            ("rmsnorm", "rmsnorm_rows"), ("flash_attention", "flash_fwd"),
            ("decode_attention", "decode_"), ("moe_gmm", "gmm_"))))
        if "device_busy_s" in out:
            out["busy_share"] = out["device_busy_s"] / t_wall
    label = "traced serve" if trace else "serve"
    print(f"{label} {arch} ({cfg.compute_dtype}, {cfg.num_layers}L "
          f"d{cfg.d_model}, 8 slots x 4096): "
          f"{out['requests']} requests, {out['prompt_tokens']} prompt + "
          f"{out['new_tokens']} new tokens in {t_wall:.3f} s wall; prefill "
          f"{out['prefill_s']:.3f} s = {out['prefill_tok_per_s']:.1f} tok/s; "
          f"decode {out['decode_s']:.3f} s over {out['ticks']} ticks = "
          f"{out['decode_tok_per_s']:.1f} tok/s, {out['ms_per_tick']:.1f} ms "
          f"a tick; TTFT p50 {out['ttft_p50_s']:.3f} s, max "
          f"{out['ttft_max_s']:.3f} s; peak memory {out['peak_mem_gb']:.2f} "
          f"GB; launches {launches}")
    del eng, model
    free_memory()
    return out


LM_REPLACES = {"rmsnorm": "src/repro/kernels/rmsnorm.py:38",
               "flash_attention": "src/repro/kernels/flash_attention.py:118",
               "decode_attention": "src/repro/kernels/decode_attention.py:71",
               "moe_gmm": "src/repro/kernels/moe_gmm.py:50"}


def lm_line(name, rows, launches, label) -> dict:
    """A kernel's entry of the ``kernels`` line: times and bound at the
    row whose label ends with ``label`` (the largest served bf16 shape),
    the largest error over every checked shape, launches of the serve."""
    mine = {lab: r for (n, lab), r in rows.items() if n == name}
    row = next(r for lab, r in mine.items() if lab.endswith(label))
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": LM_REPLACES[name], "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in mine.values()),
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}}


def serve_lm(device, arch: str) -> dict:
    """``arch`` served untraced (the returned numbers and launches), then
    once more under the profiler for the card's busy share."""
    serve = serve_phase(device, arch=arch)
    print(f"serve {arch}: " + json.dumps(serve))
    traced = serve_phase(device, trace=True, arch=arch)
    print(f"traced serve {arch}: " + json.dumps(traced))
    busy = traced.get("device_busy_s")
    print(f"device busy share of the traced serve of {arch}: " +
          (f"{traced['busy_share']:.4f} ({busy:.3f} s of "
           f"{traced['wall_s']:.2f} s wall)" if busy else "not measured"))
    return serve


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the card only",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    build_phase()
    rows = kernel_phase(device)
    operator_phase(device)
    query = main_path(device)
    print("main path: " + json.dumps(query))
    # the same query again under the profiler, for the card's busy time
    # as a share of that traced run's own wall time
    traced = main_path(device, trace=True)
    print("traced main path: " + json.dumps(traced))
    same = all(traced[k] == query[k] for k in
               ("done_t", "bytes_up", "time_to_0.5", "operators"))
    busy = traced.get("device_busy_s")
    print("device busy share of the traced query: " +
          (f"{busy / traced['wall_query_s']:.4f} ({busy:.3f} s of "
           f"{traced['wall_query_s']:.2f} s wall)" if busy
           else "not measured") +
          f"; the rerun repeats the simulated results: {same}")
    # the LM zoo's path: its kernels at the served shapes, the whole
    # model against its plain path, then the model served, untraced and
    # once more under the profiler; h2o-danube-1.8b, then
    # granite-moe-3b-a800m (each phase frees its model before the next)
    lm_rows = lm_kernel_phase(device)
    lm_parity_phase(device)
    serve = serve_lm(device, LM_ARCH)
    lm_rows.update(moe_kernel_phase(device))
    lm_rows.update(lm_kernel_phase(device, MOE_ARCH, MOE_RMS_SHAPES,
                                   MOE_FLASH_SHAPES))
    moe_parity_phase(device)
    moe_serve = serve_lm(device, MOE_ARCH)
    # the kernel's line: one 1024-frame chunk of the full-width operator,
    # its five conv layers (the main path's largest dispatch); the bound
    # is the larger of their summed bytes and summed operations' times
    main_rows = [rows[s] for s in layers(MAIN_OP)]
    t_ops = sum(r["flops"] for r in main_rows) / PEAK_FP32_FLOPS
    t_bytes = sum(r["bytes"] for r in main_rows) / PEAK_BYTES_PER_S
    print(card_line())
    print(json.dumps({"kernels": [{
        "name": "conv_scorer", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/conv_scorer.cu",
        "replaces": "src/repro/kernels/conv_scorer.py:64",
        "launches": query["conv_scorer_launches"],
        "max_abs_err": max(r["max_abs_err"] for r in rows.values()),
        "ms": sum(r["ms"] for r in main_rows),
        "plain_ms": sum(r["plain_ms"] for r in main_rows),
        "bound_ms": max(t_ops, t_bytes) * 1e3,
        "bound_by": "operations" if t_ops >= t_bytes else "bytes",
        "library_ms": sum(r["library_ms"] for r in main_rows),
    }] + [lm_line(name, lm_rows, serve["launches"][name], label)
          for name, label in (("rmsnorm", "2048x2560 bfloat16"),
                              ("flash_attention", "B=1 S=2048 bfloat16"),
                              ("decode_attention", "bfloat16"))] +
        [lm_line("moe_gmm", lm_rows, moe_serve["launches"]["moe_gmm"],
                 "C=512 1536->512 bfloat16")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
