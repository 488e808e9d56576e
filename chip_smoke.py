#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the sources in this checkout, holds
it against its plain PyTorch version at every conv layer shape of the
reduced operator family, checks the scoring runtime against the plain
forward, and then drives the port's main path: one Retrieval query for
"bus" on the 6 h Banff scene, scored through the kernel, then once more
under the CUDA profiler for the card's busy time. It prints the query's
simulated results, the card's own wall-clock numbers, one JSON line per
kernel, and as its last line
``{"ok": true, "device": {"platform": "gpu", ...}}``. Any failure exits
non-zero, and so does a host without a CUDA card.
"""
from __future__ import annotations

import contextlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from repro_torch.core import landmarks as lm  # noqa: E402
from repro_torch.core import operators as ops  # noqa: E402
from repro_torch.core.hardware import YOLO_V3  # noqa: E402
from repro_torch.core.query import Query, make_env  # noqa: E402
from repro_torch.core.ranking import RetrievalExecutor  # noqa: E402
from repro_torch.core.runtime import OperatorRuntime, set_runtime  # noqa: E402
from repro_torch.core.stepper import drive  # noqa: E402
from repro_torch.core.video import Video, corpus  # noqa: E402
from repro_torch.kernels import conv_scorer as cs, ref  # noqa: E402

# H100 SXM data sheet: fp32 outside the tensor cores, and HBM3 bandwidth
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
KERNEL_TOL = 1e-4            # tests/test_kernels.py's conv_scorer tolerance
SCORE_TOL = 1e-5
N = 1024                     # OperatorRuntime.CHUNK: the largest dispatch
FAMILY = [(2, 8, 16, 25), (3, 16, 32, 50), (4, 16, 32, 50), (5, 32, 64, 100)]
MAIN_OP = (5, 32, 64, 100)   # the full-width operator the query ships
HOURS = 6.0                  # the corpus's default scene length


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


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back launches,
    from CUDA events after a warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


# -- phase 1: build -----------------------------------------------------------

def build_phase() -> None:
    t0 = time.perf_counter()
    path = cs.build()
    print(f"build: {path.relative_to(ROOT)} in "
          f"{time.perf_counter() - t0:.3f} s")
    for line in cs.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            print(f"  ptxas: {line.strip()}")


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


def device_busy(prof) -> dict:
    """Device time traced during the query: all kernels and copies, the
    conv kernel's share, and the five largest items. Empty when the
    trace holds no device time."""
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
    return {
        "device_busy_s": total,
        "conv_scorer_device_s": sum(r[0] for r in rows
                                    if "conv3x3_bias_relu" in r[1]),
        "top_kernels": [(k[:60], round(t, 4), n) for t, k, n in rows[:5]],
    }


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
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
