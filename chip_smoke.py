#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's seven CUDA kernel sources from this checkout,
all at once, prints each kernel's registers, spills and shared memory
(and ptxas's notes on serialized wgmma pipelines; flash backward's
tensor-core kernels at head dims 64 and 80 and rmsnorm's backward at
every K may not spill), and counts
the tensor-core instructions in the SASS of the four whose bfloat16
path runs on them (HGMMA in grouped expert matmul, flash attention and
its backward, HMMA in decode attention); then takes three bf16 AdamW
steps of 2 full-width granite-moe-3b-a800m layers, to compare with the
same steps after every other phase; then drives its paths. The ZC² query path: the conv kernel
against its plain PyTorch version at every conv layer shape of the
reduced operator family, and the scorer's dense and head kernel against
its own, the scoring runtime against the plain forward and its three
dispatch layers against each other (bit for bit), and one Retrieval
query for "bus" on 1 h of the Banff scene, scored through the kernels, then
once more under the CUDA profiler for the card's busy time. The grouped
launches of the stacked superbatch (every member bit for bit the
ungrouped kernel's, timed beside 8 ungrouped launches and cuDNN's grouped
convolution), and the multi-query path: 8 mixed queries (Retrieval,
Tagging, both Countings) over three 0.25 h cameras, each standalone and
then through the FleetScheduler, bit for bit the same answers with fewer
dispatches, untraced and traced, and once more over a scoring mesh
(every card where there are two or more, else the one card named twice:
superbatches split group-wise, every Progress, the dispatch count and
the traces per arch those of the unsharded fleet), then superbatches of
n and n + 1 members on that mesh against per-demand scoring. The LM serving path, for h2o-danube-1.8b (dense) and
then granite-moe-3b-a800m (MoE): the rmsnorm, flash-attention,
decode-attention and (for granite) grouped expert matmul kernels against
their plain versions at the shapes serving the model gives them, the
full-width model on its kernel path against its plain path (float32,
then bfloat16), and 16 requests served by ``ServeEngine`` through the
kernels, untraced and then traced. The recurrent models, jamba-v0.1-52b
(Mamba, attention and MoE; full width, one 8-layer period) and
xlstm-125m (mLSTM and sLSTM; whole): the expert matmul, norm and
attention kernels at jamba's shapes and the norm at xlstm's width, each
model's float32 kernel path against its plain path, 16 requests served
(bfloat16, untraced and traced), and the recurrent mixers' eager scans
timed alone; llava-next-34b's and musicgen-large's prefills at full
width (2 layers each) with their prefix embeddings (1024 image patches;
500 audio frames, musicgen's kernels first checked at its shapes),
kernel path against plain path;
and the attention and norm kernels at
the head shapes and widths of the other accepted zoo configs
(gemma3-12b's head dim 256, llama4-maverick-400b-a17b's 5 and
granite-20b's 48 query heads per kv head, granite-20b's 6144 wide norm).
Then training: the backward kernels (rmsnorm's as one cooperative
launch, also at xlstm-125m's and h2o-danube-1.8b's widths; flash
attention's dQ and dK/dV; moe_gmm's dx and dw on its own kernel, read in
place: one call captured into a CUDA graph holds rmsnorm's one launch,
moe_gmm's two GEMM launches, and nothing else) against their plain
versions at granite-moe-3b-a800m's training shapes and
h2o-danube-1.8b's head dim 80 over 4096 tokens, each timed beside its
plain version and the library's backward, with its share of the bound;
the three AdamW steps again, bit for bit the first ones; 30 AdamW steps
of 2 full-width granite layers with wq and wk at their true fan-in, whose
loss must fall by 0.5 (the learning check); one float32 step of 2
full-width granite layers on
the kernel path against the plain path; granite-moe-3b-a800m at its
published config for 10 AdamW steps of 4 x 1024 tokens through
``repro_torch.launch.train`` (the last step traced); and xlstm-125m's
resume through ``repro_torch.launch.train``, bit for bit; and data-parallel
training over ``torch.distributed``, FSDP over "data" (2 ranks as
processes, NCCL over two cards or gloo with both on the one card; each
rank holds its slices of the weights and AdamW moments, gathers a
block's weights where it runs and reduce-scatters their gradients): a
float32 step of 2 full-width granite layers against one process on the
global batch with 2 MoE groups, each rank's gradient slices bit for bit
``sum_gradients``' slices of the whole, 2 bf16 AdamW steps with the
ranks' gathered parameters and scalars bit for bit equal after each and
each rank's peak memory, a step of the whole model on every rank beside
them, and one rank through the same path bit for bit the plain trainer;
then the "model" axis on 2 gloo ranks; then a batch of 1 over data 2 x
model 2 (4 gloo ranks on the card, each holding a quarter of every
attention ring, data major, as the JAX placement spreads ``long_500k``):
gemma3-12b's period at full width in float32 (a 4096-token prompt into
a 524,288-row ring, every row refilled, 4 ticks across the ring's end)
against one process, the ranks' logits bit for bit equal, and the dry
run's long-context cut in bf16 on each rank; decode attention's slices
at gemma3-12b's heads (131,072 of 524,288 rows; 4 of a 1,024-row
window) against their plain version. Then the dry run
(``repro_torch.launch.dryrun``): one cell of each kind counted on
PyTorch's ``meta`` device on the ``card``, ``node`` and ``pod`` meshes,
the ``pod`` and ``multipod`` placements of every cell, three cells
executed on the card (h2o-danube-1.8b's 32k prefill at batch 1 and its
decode tick at batch 8, granite-moe-3b-a800m's 4k training step cut to
2 layers at batch 4), each counted on the card exactly as on ``meta``
and timed against its roofline terms (a share above 1 fails), and the
model-axis, long-context and FSDP cuts executed on gloo ranks, each
rank's count,
collectives included, that of one device on ``meta``. It prints the
results, the card's own wall-clock numbers, one JSON line with every
kernel, and as its last line
``{"ok": true, "device": {"platform": "gpu", ...}}``. Any failure exits
non-zero, and so does a host without a CUDA card.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import os
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# cuBLAS repeats its bits run to run only with a fixed workspace, set
# before its first handle: the training phases and their resume need it
# (repro_torch.launch.train sets the same when it is imported first)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from portbench.trace import union  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import landmarks as lm  # noqa: E402
from repro_torch.core import operators as ops  # noqa: E402
from repro_torch.core.fleet import FleetScheduler, make_executor  # noqa: E402
from repro_torch.core.hardware import YOLO_V3  # noqa: E402
from repro_torch.core.query import Query, make_env  # noqa: E402
from repro_torch.core.ranking import RetrievalExecutor  # noqa: E402
from repro_torch.core.runtime import (OperatorRuntime, TraceGuard,  # noqa: E402
                                      set_runtime)
from repro_torch.core.stepper import drive  # noqa: E402
from repro_torch.core.training import FrameBank  # noqa: E402
from repro_torch.core.video import QUERY_CLASS, Video, corpus  # noqa: E402
from repro_torch.kernels import build, conv_scorer as cs, ref  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.kernels import scorer_head as sh  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.launch.mesh import make_scoring_mesh  # noqa: E402
from repro_torch.models import attention, moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.parallel import ops as pops  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as steps  # noqa: E402

# H100 SXM data sheet (the dry run's hardware model): fp32 outside the
# tensor cores, bf16 dense on the tensor cores, and HBM3 bandwidth
from repro_torch.launch.dryrun import (PEAK_BF16_FLOPS,  # noqa: E402
                                       PEAK_BYTES_PER_S, PEAK_FP32_FLOPS)
KERNEL_TOL = 1e-4            # tests/test_kernels.py's conv_scorer tolerance
SCORE_TOL = 1e-5
N = 1024                     # OperatorRuntime.CHUNK: the largest dispatch
FAMILY = [(2, 8, 16, 25), (3, 16, 32, 50), (4, 16, 32, 50), (5, 32, 64, 100)]
MAIN_OP = (5, 32, 64, 100)   # the full-width operator the query ships
# the query's scene: 1 h of the corpus's 6 h (the query runs twice,
# untraced and traced; 6 h took ~140 s of the smoke's 1200 s limit, 2 h
# 70-86 s, most of it training the operators)
HOURS = 1.0
# greedy tokens a served request (64 took ~140 s for the eight serves of
# h2o, granite, jamba and xlstm)
SERVE_NEW = 32
KERNELS = ("conv_scorer", "rmsnorm", "flash_attention", "decode_attention",
           "moe_gmm", "scorer_head", "flash_attention_bwd")
LM_ARCH = "h2o-danube-1.8b"  # examples/serve_lm.py's default model
MOE_ARCH = "granite-moe-3b-a800m"   # ROADMAP's MoE configuration
LM_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}  # tests/test_kernels.py
# a slice's log-sum-exp is float32 scores' in both types (the kernel's
# and the plain version's bf16 products are exact in float32); relative
# to the largest |lse|, at least 1
LSE_TOL = 1e-4
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
# the other accepted configs' head shapes and widths: gemma3-12b's 16/8
# heads of 256 (window 1024), granite-20b's 48/1 and
# llama4-maverick-400b-a17b's 40/8 heads of 128 in a decode tick, and
# granite-20b's 6144-wide norm
WIDE_HEAD_ARCH = "gemma3-12b"
WIDE_FLASH_SHAPES = ((257, torch.bfloat16), (257, torch.float32),
                     (2048, torch.bfloat16), (2048, torch.float32))
WIDE_RMS_ARCH = "granite-20b"
WIDE_RMS_SHAPES = ((2048, torch.bfloat16), (8, torch.bfloat16),
                   (2048, torch.float32))
GROUP_ARCHS = ("llama4-maverick-400b-a17b", "granite-20b")
# the recurrent and prefix-embedding configs. jamba-v0.1-52b at full width
# with its depth cut to one 8-layer period (1 attention, 7 Mamba, 4 MoE
# layers; 13.3 B parameters, 26.6 GB in bf16, 53 GB in float32): its 32
# layers (104 GB in bf16) do not fit one card. xlstm-125m whole.
# The frontends' prefills at full width, 2 layers each: llava-next-34b's
# 1024 image-patch embeddings (its config's num_prefix_embeds) before 512
# tokens; musicgen-large's 500 audio frames (a 10 s melody prompt at
# EnCodec's 50 Hz) before 1000 tokens, the 30 s it generates
HYBRID_ARCH = "jamba-v0.1-52b"
XLSTM_ARCH = "xlstm-125m"
VLM_ARCH = "llava-next-34b"
MUSIC_ARCH = "musicgen-large"
CUT_LAYERS = {HYBRID_ARCH: 8, VLM_ARCH: 2, MUSIC_ARCH: 2}
PREFIXES = {VLM_ARCH: (1024, 512), MUSIC_ARCH: (500, 1000)}
# musicgen-large's norm (d 2048) and attention (32/32 heads of 64) of its
# 1500-row prefill and an 8-slot tick
MUSIC_RMS_SHAPES = ((1500, torch.bfloat16), (8, torch.bfloat16))
MUSIC_FLASH_SHAPES = ((1500, torch.bfloat16), (1500, torch.float32))
# jamba's norm of a prefill and of a tick, a 2048-token prompt's attention
# (32/8 heads of 128); xlstm's 768-wide norm of a prefill
HYBRID_RMS_SHAPES = ((2048, torch.bfloat16), (8, torch.bfloat16),
                     (2048, torch.float32))
HYBRID_FLASH_SHAPES = ((2048, torch.bfloat16), (2048, torch.float32))
XLSTM_RMS_SHAPES = ((2048, torch.bfloat16),)
# jamba's expert products: 16 experts, capacity 8 in an 8-slot tick and
# 320 in a 2048-token prompt (ceil(2048*2*1.25/16)); 4096 -> 14336 for
# the gate and up products, 14336 -> 4096 for the down product
HYBRID_GMM_CAPS = (8, 320)
HYBRID_GMM_DIMS = ((4096, 14336), (14336, 4096))
# prompts the recurrent mixers' chunked scans take (up to their chunk of
# 512 or 256 tokens, or a multiple of it): the parity phases' four, and
# the serves' draws, 128-256 tokens or one of 512, 1024, 2048
RECURRENT_PROMPTS = (5, 77, 1024, 2048)
RECURRENT_LONG = (512, 1024)   # not 2048: xlstm's eager sLSTM took ~20 s
# the mixers alone: a prompt's prefill and an 8-slot decode step
SCAN_TOKENS, SCAN_SLOTS = 2048, 8
HYBRID_LABEL = "C=320 4096->14336 bfloat16"   # jamba's row in the kernels line
# training (granite-moe-3b-a800m at batch 4 x 1024 tokens): the backward
# kernels at its shapes (rmsnorm over 4096 rows of 1536; flash over 4 x
# 1024 tokens of 24/8 heads of 64; moe_gmm's dx and dw at 40 experts of
# capacity 1024, 1536 <-> 512), and h2o-danube-1.8b's head dim 80 with its
# 4096 window over one 4096-token row
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}   # relative to max
TRAIN_ARCH = MOE_ARCH
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 1024, 10
TRAIN_GRAD_TOL = 1e-3        # float32 parity of every gradient, relative
STEP_BITS_STEPS = 3          # steps of the history check (step_bits_phase)
# rmsnorm's backward also over 4096 rows of xlstm-125m's and
# h2o-danube-1.8b's widths
RMS_BWD_WIDTHS = (768, 2560)
# the learning check (learn_phase): 2 full-width granite layers, wq and
# wk at their true fan-in, AdamW at lr 1e-3 (3 warm-up steps) for 30
# steps of 4 x 1024 tokens; the mean loss of the last 5 steps must be at
# least 0.5 below that of the first 5 (set before any run)
LEARN_STEPS, LEARN_WINDOW, LEARN_DROP = 30, 5, 0.5
RESUME_ARCH = XLSTM_ARCH
RESUME_BATCH, RESUME_SEQ, RESUME_STEPS = 4, 256, 8
# data-parallel training (dp_train_phase): 2 ranks on 2 full-width granite
# layers (wq and wk at their true fan-in), the global batch of 4 x 1024
# split 2 x 1024 a rank; 2 bf16 AdamW steps; each group of ranks under a
# time limit
DP_RANKS, DP_STEPS, DP_TIMEOUT = 2, 2, 420
# the dry run's FSDP cut: arch, shape, layers, the data ranks' rows
# (timed as every executed cell, ``dryrun.ITERS`` steps after
# ``WARMUP``: a step ~5 s, gloo through the host)
DP_DRYRUN = ("granite-moe-3b-a800m", "train_4k", 2, 4)
# the stacked superbatch: members of a grouped launch checked against the
# ungrouped kernel (the fleet's group_max is 8), images a member in the
# check, the head's row counts (the small layer's 20 real rows, the
# smallest bucket, a chunk), and the members of the timed grouped chunk
GROUP_QS = (2, 3, 8)
GROUP_N = 256
GROUP_MS = (20, 64, 1024)
GROUP_TIMED = 8
# the fleet: tests/test_fleet.py's 8 mixed queries over three cameras,
# the reduced family; 0.25 h of video each (at 1 h the phase took
# 275-340 s and the script 763-864 s of its 1200; at 0.5 h the four fleet
# runs ~150 s, at 0.25 h ~130 s); 50 training steps an operator (make_env's
# 150 took most of the fleet's host time)
FLEET_HOURS = 0.25
FLEET_TRAIN_STEPS = 50
FLEET_CAMERAS = ("JacksonH", "Banff", "Miami")
FLEET_SPECS = (("JacksonH", "retrieval", {"max_passes": 2}),
               ("Banff", "retrieval", {"max_passes": 2}),
               ("JacksonH", "count_max", {"max_passes": 2}),
               ("Miami", "count_max", {"max_passes": 2}),
               ("Banff", "tagging", {}),
               ("Miami", "tagging", {}),
               ("Banff", "count_avg", {}),
               ("Miami", "count_median", {}))
# the profiler's rows of host-to-device copies, by where the host memory
# lies
HTOD = {"htod_pageable_s": "Memcpy HtoD (Pageable -> Device)",
        "htod_pinned_s": "Memcpy HtoD (Pinned -> Device)"}
# the scorer's dense and head layers at the query's largest dispatch:
# 1024 frames of op_L5c32s100 (4 x 4 x 32 features, 64 dense units)
HEAD_SHAPE = (N, 512, 64)
# grouped expert matmul: capacity C of a decode tick (8 slots), of
# 128-, 1100- and 2048-token prompts (32, 275, 512: ceil(S*8*1.25/40),
# at least 8), each for the gate/up (1536 -> 512) and down (512 -> 1536)
# products
GMM_CAPS = (8, 32, 275, 512)
GMM_DIMS = ((1536, 512), (512, 1536))
# the kernels whose bf16 path runs on the tensor cores, with the name
# their bf16 kernels carry and the instruction they must hold: wgmma fed
# by TMA (HGMMA) in grouped expert matmul (forward and backward), flash
# attention and its backward (dQ and dK/dV at head dims 16-128), mma.sync
# (HMMA) in decode attention
TC_KERNELS = {"moe_gmm": ("gmm_wgmma", "HGMMA"),
              "flash_attention": ("flash_fwd_wgmma", "HGMMA"),
              "flash_attention_bwd": ("_wgmma", "HGMMA"),
              "decode_attention": ("decode_bf16", "HMMA")}
# kernels that must compile without spilling, by source: flash
# backward's tensor-core kernels at the trained head dims (granite's 64,
# h2o's 80), and rmsnorm's backward at every K (its prefetched rows and
# column sums live in registers)
NO_SPILL = {"flash_attention_bwd": ("flash_bwd_dq_wgmma<64>",
                                    "flash_bwd_dkdv_wgmma<64>",
                                    "flash_bwd_dq_wgmma<80>",
                                    "flash_bwd_dkdv_wgmma<80>"),
            "rmsnorm": ("rmsnorm_bwd_kernel",)}


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


def conv_bound(n, h, cin, cout):
    """Least time (ms) of one conv_scorer call and what sets it: bytes
    (x, w, b read once, out written once) over the memory rate, or fp32
    operations (2*Cin per in-bounds tap of each output) over the fp32
    peak (``conv_scorer.cost``)."""
    flops, nbytes = cs.cost((n, h, h, cin), cout)
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
    each kernel, and the tensor-core instructions (``HGMMA``, ``HMMA``) in
    the SASS of each kernel of the three sources whose bf16 path runs on
    the tensor cores: every bf16 kernel there must hold some, the float32
    ones run on the CUDA cores."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        paths = dict(zip(KERNELS, pool.map(build.build, KERNELS)))
    print(f"build: {len(KERNELS)} kernels in parallel in "
          f"{time.perf_counter() - t0:.3f} s")
    for name, path in paths.items():
        print(f"build: {path.relative_to(ROOT)}")
        log = build.logs.get(name, "")
        res = build.resources(log)
        short = demangle(r["kernel"] for r in res)
        for r in res:
            print(f"  ptxas {short[r['kernel']]}: {r['registers']} "
                  f"registers, {r['spill_stores']} B spill stores, "
                  f"{r['spill_loads']} B spill loads, {r['smem']} B static "
                  f"smem")
            if any(k in short[r["kernel"]] for k in NO_SPILL.get(name, ())):
                check(r["spill_stores"] == r["spill_loads"] == 0,
                      f"{short[r['kernel']]} spills")
        # ptxas's notes on wgmma pipelines it had to serialize
        for line in log.splitlines():
            if "Performance Loss" in line:
                print("  " + line.strip())
        if name in NO_SPILL and name in build.logs and \
                any(k != v for k, v in short.items()):   # demangled
            found = [k for k in NO_SPILL[name]
                     if any(k in short[r["kernel"]] for r in res)]
            check(len(found) == len(NO_SPILL[name]),
                  f"ptxas lines of {NO_SPILL[name]} not found: {found}")
    for name, (tag, opcode) in TC_KERNELS.items():
        counts = build.sass_counts(name, opcode)
        short = demangle(counts)
        tc = {k: v for k, v in counts.items() if tag in k}
        print(f"sass {name}: " + "; ".join(
            f"{short[k]} {opcode} {v}" for k, v in counts.items()))
        check(bool(tc) and all(tc.values()),
              f"{name}: a bf16 kernel without {opcode} instructions {tc}")


# -- phase 2: the kernel against its plain version ----------------------------

def kernel_phase(device) -> dict:
    """Every conv layer shape of the reduced family at N = 1024: the
    kernel against ``ref.conv_scorer`` (<= 1e-4), an image's result the
    same at N 1 and 33, then timed beside the plain version and one cuDNN
    call (conv + bias, TF32 off: the yardstick, never called by the
    port), in turns, with the launches queued ahead (``LEAD_CYCLES``), so
    that a small layer's time is the card's and not the host's."""
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
        for n in (1, 33):
            check(torch.equal(cs.conv_scorer(x[-n:].clone(), w, b),
                              got[-n:]),
                  f"conv_scorer H{h} {cin}->{cout}: an image's result "
                  f"depends on N ({n} against {N})")
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
                                    "library": library}[name],
                                   lead_cycles=LEAD_CYCLES))
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
    chunk = [rows[s] for s in layers(MAIN_OP)]
    t = {k: sum(r[k] for r in chunk) for k in ("ms", "library_ms")}
    print(f"kernel conv_scorer, one {N}-frame chunk of op_L5c32s100 (5 "
          f"layers): kernel {t['ms']:.4f} ms, cuDNN {t['library_ms']:.4f} "
          f"ms, kernel / cuDNN {t['ms'] / t['library_ms']:.3f}")
    return rows


def head_phase(device) -> dict:
    """The scorer's dense and head kernel at the query's largest dispatch
    (``HEAD_SHAPE``) against ``ref.scorer_head`` (<= 1e-5), a row's bits
    independent of M, timed beside the plain version. No one PyTorch
    call computes the two layers, so it has no library time."""
    m, feat, dense = HEAD_SHAPE
    g = torch.Generator(device=device).manual_seed(5)
    h = torch.rand(m, feat, generator=g, device=device)
    wd = torch.randn(feat, dense, generator=g, device=device) * \
        (2.0 / feat) ** 0.5
    bd = 0.1 * torch.randn(dense, generator=g, device=device)
    wh = torch.randn(dense, 2, generator=g, device=device) / dense ** 0.5
    bh = 0.1 * torch.randn(2, generator=g, device=device)
    args = (h, wd, bd, wh, bh)
    got = sh.scorer_head(*args)
    err = float((got - ref.scorer_head(*args)).abs().max())
    check(math.isfinite(err) and err <= SCORE_TOL,
          f"scorer_head: max |err| {err} > {SCORE_TOL}")
    check(torch.equal(sh.scorer_head(h[-20:].clone(), *args[1:]),
                      got[-20:]), "scorer_head: a row depends on M")
    t = {"plain": [], "kernel": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        fn = (lambda: sh.scorer_head(*args)) if name == "kernel" else \
            (lambda: ref.scorer_head(*args))
        t[name].append(time_ms(fn, iters=50, lead_cycles=LEAD_CYCLES))
    bound, by = _bound(*sh.cost(m, feat, dense), torch.float32)
    row = {"max_abs_err": err, "ms": float(np.mean(t["kernel"])),
           "plain_ms": float(np.mean(t["plain"])), "library_ms": None,
           "bound_ms": bound, "bound_by": by}
    print(f"kernel scorer_head M={m} {feat}->{dense}->2: max|err| "
          f"{err:.3e}  kernel {row['ms']:.4f} ms  plain "
          f"{row['plain_ms']:.4f} ms  library none  bound {bound:.4f} ms "
          f"({by})  share of bound {bound / row['ms']:.3f}")
    return row


def head_dims(sig):
    """(feat, dense) of an operator signature's dense layer."""
    n_layers, channels, dense, size = sig
    for _ in range(n_layers):
        size = -(-size // 2)
    return size * size * channels, dense


def _group_conv_inputs(q, n, h, cin, cout, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.rand((q, n, h, h, cin), generator=g, device=device),
            torch.randn((q, 3, 3, cin, cout), generator=g, device=device)
            / math.sqrt(9 * cin),
            torch.randn((q, cout), generator=g, device=device))


def _group_head_inputs(q, m, feat, dense, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.rand((q, m, feat), generator=g, device=device),
            torch.randn((q, feat, dense), generator=g, device=device)
            * (2.0 / feat) ** 0.5,
            0.1 * torch.randn((q, dense), generator=g, device=device),
            torch.randn((q, dense, 2), generator=g, device=device)
            / dense ** 0.5,
            0.1 * torch.randn((q, 2), generator=g, device=device))


def grouped_library(x, w, b):
    """One cuDNN grouped convolution (``groups=Q``) over the members
    stacked on the channel axis, TF32 off, and its output back in the
    kernel's layout: the grouped launch's yardstick, timed only."""
    q, n, h, _, cin = x.shape
    cout = w.shape[-1]
    _, top, bottom = ref.same_pad(h, 2)
    xp = F.pad(x.permute(1, 0, 4, 2, 3).reshape(n, q * cin, h, h),
               (top, bottom) * 2).contiguous(memory_format=torch.channels_last)
    wl = w.permute(0, 4, 3, 1, 2).reshape(q * cout, cin, 3, 3).contiguous(
        memory_format=torch.channels_last)
    bl = b.reshape(q * cout)

    def library():
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return F.conv2d(xp, wl, bl, stride=2, groups=q)

    def as_kernel(out):
        ho = out.shape[-1]
        return out.reshape(n, q, cout, ho, ho).permute(1, 0, 3, 4, 2).relu()

    return library, as_kernel


def grouped_kernel_phase(device) -> dict:
    """The grouped launches of the stacked superbatch. Bits: at every
    conv layer shape of the reduced family and Q 2, 3 and 8, every
    member of one grouped launch equals the ungrouped kernel on its own
    inputs (max|diff| == 0), and the launch is within 1e-4 of the plain
    version; the same for the dense-and-head kernel at the family's
    heads and M 20, 64 and 1024. Times, with the launches queued ahead:
    Q 8 x 1024 frames of op_L5c32s100's five layers as one grouped launch
    a layer, beside 8 ungrouped launches a layer and one cuDNN grouped
    convolution a layer (timed only), and the head at Q 8 x 1024; the
    bound is 8 times the single chunk's bytes and operations."""
    shapes = sorted({s for sig in FAMILY for s in layers(sig)},
                    key=lambda s: (-s[0], s[1], s[2]))
    worst = err_max = 0.0
    for h, cin, cout in shapes:
        for q in GROUP_QS:
            x, w, b = _group_conv_inputs(q, GROUP_N, h, cin, cout, device,
                                         seed=h * 1000 + cin * 10 + q)
            got = cs.conv_scorer(x, w, b)
            diff = max(float((got[m] - cs.conv_scorer(
                x[m].clone(), w[m].clone(), b[m].clone())).abs().max())
                for m in range(q))
            err = float((got - ref.conv_scorer_grouped(x, w, b)).abs().max())
            check(diff == 0, f"grouped conv_scorer H{h} {cin}->{cout} Q {q}: "
                  f"a member differs from the ungrouped kernel by {diff}")
            check(math.isfinite(err) and err <= KERNEL_TOL,
                  f"grouped conv_scorer H{h} {cin}->{cout} Q {q}: max |err| "
                  f"{err} > {KERNEL_TOL}")
            worst, err_max = max(worst, diff), max(err_max, err)
            del x, w, b, got
    print(f"kernel grouped conv_scorer: {len(shapes)} family layers x Q "
          f"{GROUP_QS}, {GROUP_N} images a member: members vs the ungrouped "
          f"kernel max|diff| {worst}; vs plain max|err| {err_max:.3e}")
    head_worst = head_err = 0.0
    heads = sorted({head_dims(sig) for sig in FAMILY})
    for feat, dense in heads:
        for q in GROUP_QS:
            for m in GROUP_MS:
                args = _group_head_inputs(q, m, feat, dense, device,
                                          seed=feat + dense + q + m)
                got = sh.scorer_head(*args)
                # each member's own tensors (a slice of bh is not 16-byte
                # aligned, which the ungrouped kernel needs)
                diff = max(float((got[j] - sh.scorer_head(
                    *(a[j].clone() for a in args))).abs().max())
                    for j in range(q))
                err = float((got - ref.scorer_head_grouped(*args)).abs().max())
                check(diff == 0, f"grouped scorer_head {feat}->{dense} Q {q} "
                      f"M {m}: a member differs by {diff}")
                check(math.isfinite(err) and err <= SCORE_TOL,
                      f"grouped scorer_head {feat}->{dense} Q {q} M {m}: max "
                      f"|err| {err}")
                head_worst, head_err = max(head_worst, diff), max(head_err,
                                                                  err)
    print(f"kernel grouped scorer_head: heads {heads} x Q {GROUP_QS} x M "
          f"{GROUP_MS}: members vs the ungrouped kernel max|diff| "
          f"{head_worst}; vs plain max|err| {head_err:.3e}")

    q = GROUP_TIMED
    t = {"kernel": 0.0, "single": 0.0, "library": 0.0}
    flops = nbytes = 0.0
    for h, cin, cout in layers(MAIN_OP):
        x, w, b = _group_conv_inputs(q, N, h, cin, cout, device, seed=h)
        library, as_kernel = grouped_library(x, w, b)
        check(float((as_kernel(library()) - cs.conv_scorer(x, w, b))
                    .abs().max()) <= KERNEL_TOL,
              "cuDNN's grouped yardstick disagrees with the kernel")
        fns = {"kernel": lambda: cs.conv_scorer(x, w, b),
               "single": lambda: [cs.conv_scorer(x[m], w[m], b[m])
                                  for m in range(q)],
               "library": library}
        runs = {k: [] for k in fns}
        for name in ("kernel", "single", "library", "library", "single",
                     "kernel"):
            runs[name].append(time_ms(fns[name], iters=10,
                                      lead_cycles=LEAD_CYCLES))
        for k in t:
            t[k] += float(np.mean(runs[k]))
        _, _, f1, b1 = conv_bound(N, h, cin, cout)
        flops, nbytes = flops + q * f1, nbytes + q * b1
        del x, w, b, library
        torch.cuda.empty_cache()
    bound, by = _bound(flops, nbytes, torch.float32)
    conv = {"members": q, "ms": t["kernel"], "single_x8_ms": t["single"],
            "bound_ms": bound, "bound_by": by, "library_ms": t["library"],
            "max_abs_err": err_max, "max_member_diff": worst}
    print(f"kernel grouped conv_scorer, Q {q} x {N} frames of op_L5c32s100 "
          f"(5 layers, one launch a layer): grouped {t['kernel']:.4f} ms, "
          f"{q} ungrouped launches a layer {t['single']:.4f} ms, cuDNN "
          f"groups={q} {t['library']:.4f} ms, bound {bound:.4f} ms ({by}), "
          f"share of bound {bound / t['kernel']:.3f}")

    m, feat, dense = HEAD_SHAPE
    args = _group_head_inputs(q, m, feat, dense, device, seed=7)
    own = [[a[j].clone() for a in args] for j in range(q)]
    fns = {"kernel": lambda: sh.scorer_head(*args),
           "single": lambda: [sh.scorer_head(*own[j]) for j in range(q)],
           "plain": lambda: ref.scorer_head_grouped(*args)}
    runs = {k: [] for k in fns}
    for name in ("plain", "kernel", "single", "single", "kernel", "plain"):
        runs[name].append(time_ms(fns[name], iters=50,
                                  lead_cycles=LEAD_CYCLES))
    th = {k: float(np.mean(v)) for k, v in runs.items()}
    bound_h, by_h = _bound(*sh.cost(m, feat, dense, q), torch.float32)
    head = {"members": q, "ms": th["kernel"], "single_x8_ms": th["single"],
            "plain_ms": th["plain"], "bound_ms": bound_h, "bound_by": by_h,
            "max_abs_err": head_err, "max_member_diff": head_worst}
    print(f"kernel grouped scorer_head, Q {q} x M {m} {feat}->{dense}->2: "
          f"grouped {th['kernel']:.4f} ms, {q} ungrouped launches "
          f"{th['single']:.4f} ms, plain {th['plain']:.4f} ms, bound "
          f"{bound_h:.4f} ms ({by_h}), share of bound "
          f"{bound_h / th['kernel']:.3f}")
    return {"conv_scorer": conv, "scorer_head": head}


# -- phase 3: the scoring runtime against the plain forward -------------------

def grouped_counts() -> dict:
    return {"conv_scorer": cs.conv_scorer.grouped_launches,
            "scorer_head": sh.scorer_head.grouped_launches}


def scoring_counts() -> dict:
    """The scoring kernels' launches, all and grouped."""
    return {"conv_scorer": cs.conv_scorer.launches,
            "scorer_head": sh.scorer_head.launches,
            **{f"{k}_grouped": v for k, v in grouped_counts().items()}}


def zero_scoring_counts() -> None:
    for f in (cs.conv_scorer, sh.scorer_head):
        f.launches = 0
        f.grouped_launches = 0


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

    before = grouped_counts()
    (pg, cg), _ = bucketed.score_demands(
        [(Trained(), Bank(), np.arange(20)),
         (Trained(), Bank(), np.arange(20, 40))], group_max=2)
    moved = {k: v - before[k] for k, v in grouped_counts().items()}
    check(small.small_calls == 1 and bucketed.super_calls == 1,
          "layer selection")
    if device.type == "cuda":
        # the superbatch: one grouped launch a conv layer, one of the head
        check(moved == {"conv_scorer": sig[0], "scorer_head": 1},
              f"the superbatch's grouped launches {moved}")
    rows = {"small": [s[0] for v in small.shape_vocab().values() for s in v],
            "bucketed": [s[:-3] for v in bucketed.shape_vocab().values()
                         for s in v]}
    check(rows == {"small": [32], "bucketed": [(2, 64), (64,)]},
          f"dispatch shapes {rows}")
    d_sb = max(float(np.abs(ps - pb).max()), float(np.abs(cs_ - cb).max()))
    d_gb = max(float(np.abs(pg - pb).max()), float(np.abs(cg - cb).max()))
    print(f"F2 rows {rows}: small vs bucketed max|diff| {d_sb:.3e}; "
          f"superbatch (grouped launches {moved}) vs bucketed max|diff| "
          f"{d_gb:.3e}")
    # the convs and the dense and head layers reduce each row in an order
    # that does not depend on the row count: the layers agree bit for bit
    check(d_sb == 0 and d_gb == 0, "dispatch layers disagree")


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
    zero_scoring_counts()
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
    head_launches = sh.scorer_head.launches
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
        check(head_launches > 0, "the main path launched no scorer_head "
              "kernel")
        check(rt.pinned_copies == rt.calls,
              "a dispatch's input was not copied from page-locked memory")
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
        "scorer_head_launches": head_launches,
        "pinned_copies": rt.pinned_copies,
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
          f"dispatch {rt.dispatch_stats()}; conv_scorer launches {launches}, "
          f"scorer_head launches {head_launches}")
    print(f"{label} (card): rendering + crops {wall['crops']:.2f} s of "
          f"host wall")
    if trace:
        print(f"traced query (card): device busy "
              + (f"{busy['device_busy_s']:.3f} s (conv_scorer "
                 f"{busy['conv_scorer_device_s']:.3f} s, scorer_head "
                 f"{busy['scorer_head_device_s']:.4f} s), top "
                 f"{busy['top_kernels']}" if busy else "not measured"))
        print(f"traced query (card): {copy_split(busy)}; inputs copied "
              f"from page-locked memory {rt.pinned_copies} of {rt.calls} "
              f"dispatches")
    return out


def copy_split(busy: dict) -> str:
    if not busy:
        return "host-to-device copies not measured"
    return (f"host-to-device copies: pageable {busy['htod_pageable_s']:.4f} s, "
            f"pinned {busy['htod_pinned_s']:.4f} s; copy rows "
            f"{busy['copies']}")


def device_busy(prof, kernels=(("conv_scorer", "conv3x3_bias_relu"),
                              ("scorer_head", "dense_head"))) -> dict:
    """Device time traced during a run: the time some kernel or copy ran
    (the union of their intervals: overlapping ones count once), each
    named kernel's summed time (``(label, name substring)`` pairs), and
    the largest items. Empty when the trace holds no device time."""
    # read from the trace's raw events: ``key_averages`` builds a Python
    # object an event, minutes for the million launches of a serve whose
    # sLSTM runs one eager step a token
    by_name, spans = {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            t, n = by_name.get(e.name(), (0, 0))
            by_name[e.name()] = (t + e.duration_ns(), n + 1)
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns()))
    rows = [(t * 1e-9, k, n) for k, (t, n) in by_name.items()]
    busy = sum(b - a for a, b in union(spans)) * 1e-9
    if busy <= 0:
        return {}
    rows.sort(reverse=True)
    out = {"device_busy_s": busy}
    for label, sub in kernels:
        out[f"{label}_device_s"] = sum(r[0] for r in rows if sub in r[1])
    for label, key in HTOD.items():
        out[label] = sum(r[0] for r in rows if key in r[1])
    out["copies"] = [(k[:40], round(t, 4), n) for t, k, n in rows
                     if "Memcpy" in k or "Memset" in k]
    out["top_kernels"] = [(k[:60], round(t, 4), n) for t, k, n in rows[:8]]
    return out


# -- phase 4b: the multi-query main path ------------------------------------

def fleet_executor(videos, stores, banks, cam, kind, train_steps):
    env = make_env(videos[cam], Query(kind, QUERY_CLASS[cam]), stores[cam],
                   bank=banks[cam], train_steps=train_steps)
    ex = make_executor(env, full_family=False)
    if kind == "tagging":
        ex.levels = (30, 10, 1)          # tests/test_fleet.py's levels
    return ex


def _progress(p) -> tuple:
    return (p.points, p.bytes_up, p.done_t, p.op_switches)


def fleet_phase(device, hours: float = FLEET_HOURS,
                train_steps: int = FLEET_TRAIN_STEPS) -> dict:
    """The 8 mixed queries of ``FLEET_SPECS`` over three cameras, ``hours``
    of video each, through the port's entry points, three times: each
    query standalone on a fresh runtime; all eight through an uncontended
    ``FleetScheduler`` (verification routed through the shared
    ``OracleService``) on a fresh runtime inside a ``TraceGuard``; and
    that again under the CUDA profiler. Each run starts with fresh frame
    banks, so each renders its own frames. Checks: every query's
    Progress in the fleet is its standalone run's bit for bit, fewer
    dispatches and fewer conv launches than standalone, stacked
    superbatches through the grouped kernels, no retrace."""
    t0 = time.perf_counter()
    videos = {n: Video(corpus(hours=hours)[n]) for n in FLEET_CAMERAS}
    stores = {n: lm.build_landmarks(v, 30, YOLO_V3)
              for n, v in videos.items()}
    t_world = time.perf_counter() - t0
    cuda = device.type == "cuda"

    def runtime():
        return OperatorRuntime() if cuda else OperatorRuntime(device=device)

    def banks():
        return {n: FrameBank(v) for n, v in videos.items()}

    # run 1: each query standalone
    solo, solo_calls, solo_stats = [], 0, []
    bank = banks()
    zero_scoring_counts()
    t1 = time.perf_counter()
    for cam, kind, kw in FLEET_SPECS:
        rt = runtime()
        prev = set_runtime(rt)
        try:
            solo.append(fleet_executor(videos, stores, bank, cam, kind,
                                       train_steps).run(**kw))
        finally:
            set_runtime(prev)
        solo_calls += rt.calls
        solo_stats.append(rt.dispatch_stats())
    if cuda:
        torch.cuda.synchronize()
    wall_solo = time.perf_counter() - t1
    solo_launches = scoring_counts()

    def fleet_run(trace: bool, mesh=None):
        sched = FleetScheduler(contended=False, mesh=mesh)
        # with a mesh the fleet scores through a runtime of its own, which
        # the queries' own scoring shares (as the JAX package's sharded
        # fleet test runs it), so the dispatch counts compare
        rt = sched.runtime if mesh is not None else runtime()
        prev = set_runtime(rt)
        bank = banks()
        for i, (cam, kind, kw) in enumerate(FLEET_SPECS):
            sched.add(f"q{i}", cam, fleet_executor(videos, stores, bank, cam,
                                                   kind, train_steps), **kw)
        profiler = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) \
            if trace else contextlib.nullcontext()
        zero_scoring_counts()
        t = time.perf_counter()
        try:
            with profiler, TraceGuard(rt) as guard:
                res = sched.run()
                if cuda:
                    torch.cuda.synchronize()
        finally:
            set_runtime(prev)
        wall = time.perf_counter() - t
        launches = scoring_counts()
        return (res, sched, rt, guard, wall, launches,
                device_busy(profiler) if trace else {})

    res, sched, rt, guard, wall, launches, _ = fleet_run(trace=False)
    for i, p in enumerate(solo):
        check(_progress(res[f"q{i}"]) == _progress(p),
              f"fleet query q{i} ({FLEET_SPECS[i][:2]}) differs from its "
              "standalone run")
    stats = sched.stats
    check(stats["dispatches"] < solo_calls,
          f"fleet dispatches {stats['dispatches']} >= standalone "
          f"{solo_calls}")
    check(rt.super_calls > 0, "the fleet stacked no superbatch")
    if cuda:
        check(0 < launches["conv_scorer"] < solo_launches["conv_scorer"],
              f"conv_scorer launches: fleet {launches['conv_scorer']}, "
              f"standalone {solo_launches['conv_scorer']}")
        check(launches["scorer_head"] > 0 and
              launches["conv_scorer_grouped"] > 0 and
              launches["scorer_head_grouped"] > 0,
              f"the fleet's launches {launches}")
        check(rt.pinned_copies == rt.calls,
              "a dispatch's input was not copied from page-locked memory")
    tres, _, _, _, twall, _, busy = fleet_run(trace=cuda)
    check(all(_progress(tres[f"q{i}"]) == _progress(p)
              for i, p in enumerate(solo)),
          "the traced fleet run differs from the standalone runs")
    frames = sum(v.spec.num_frames for v in videos.values())
    solo_dispatch = {k: sum(d[k] for d in solo_stats)
                     for k in solo_stats[0]}
    out = {
        "queries": len(FLEET_SPECS), "cameras": len(FLEET_CAMERAS),
        "hours_per_camera": hours, "frames": frames,
        "wall_world_s": t_world, "wall_standalone_s": wall_solo,
        "wall_fleet_s": wall, "wall_traced_fleet_s": twall,
        "standalone_dispatch": solo_dispatch,
        "fleet_dispatch": rt.dispatch_stats(),
        "standalone_launches": solo_launches, "fleet_launches": launches,
        "watermark_fires": stats["watermark_fires"],
        "eager_dispatches": stats["eager_dispatches"],
        "score_rounds": stats["score_rounds"],
        "overlap_host_s": stats["overlap_host_s"],
        "result_block_s": stats["result_block_s"],
        "traces_per_arch": guard.traces_per_arch,
        "n_compiled": rt.n_compiled, "pinned_copies": rt.pinned_copies,
        "done_t": {f"q{i}": p.done_t for i, p in enumerate(solo)},
        **busy,
    }
    if busy:
        out["busy_share"] = busy["device_busy_s"] / twall
    print(f"fleet ({len(FLEET_SPECS)} queries, {len(FLEET_CAMERAS)} cameras x "
          f"{hours} h, {frames} frames): every Progress equals its "
          f"standalone run's bit for bit; walls standalone {wall_solo:.2f} s, "
          f"fleet {wall:.2f} s (traced {twall:.2f} s); dispatches "
          f"standalone {solo_calls}, fleet {stats['dispatches']} "
          f"({rt.dispatch_stats()}); conv_scorer launches standalone "
          f"{solo_launches['conv_scorer']}, fleet {launches}; watermark "
          f"fires {stats['watermark_fires']}, eager dispatches "
          f"{stats['eager_dispatches']}, score rounds "
          f"{stats['score_rounds']}; overlap_host_s "
          f"{stats['overlap_host_s']}, result_block_s "
          f"{stats['result_block_s']}; traces per arch "
          f"{guard.traces_per_arch}, none retraced; inputs copied from "
          f"page-locked memory {rt.pinned_copies} of {rt.calls} dispatches")
    print("traced fleet (card): device busy " +
          (f"{busy['device_busy_s']:.3f} s of {twall:.2f} s wall = share "
           f"{out['busy_share']:.4f} (conv_scorer "
           f"{busy['conv_scorer_device_s']:.3f} s, scorer_head "
           f"{busy['scorer_head_device_s']:.4f} s), top "
           f"{busy['top_kernels']}" if busy else "not measured") +
          f"; {copy_split(busy)}")
    # the same fleet over a scoring mesh: superbatches split group-wise
    devs = mesh_devices(device)
    mesh = make_scoring_mesh(devs)
    mres, msched, mrt, mguard, mwall, mlaunches, _ = fleet_run(
        trace=False, mesh=mesh)
    for i in range(len(FLEET_SPECS)):
        check(_progress(mres[f"q{i}"]) == _progress(res[f"q{i}"]),
              f"sharded fleet query q{i} differs from the unsharded fleet's")
    mstats = msched.stats
    check(mstats["dispatches"] == stats["dispatches"],
          f"dispatches: sharded {mstats['dispatches']}, unsharded "
          f"{stats['dispatches']}")
    check(mguard.traces_per_arch == guard.traces_per_arch,
          f"traces per arch: sharded {mguard.traces_per_arch}, unsharded "
          f"{guard.traces_per_arch}")
    check(mstats["sharded"] and mstats["device_count"] == len(devs),
          f"the sharded fleet's stats {mstats}")
    check(sum(mrt.slot_parts["super"][1:]) > 0,
          f"no superbatch was split: {mrt.slot_parts}")
    out["sharded"] = {
        "devices": [str(d) for d in devs], "wall_s": mwall,
        "wall_unsharded_s": wall, "dispatches": mstats["dispatches"],
        "slot_parts": mrt.slot_parts, "launches": mlaunches,
        "fallbacks": mrt.sharding_fallbacks(),
        "traces_per_arch": mguard.traces_per_arch,
        "group_max": msched.group_max}
    print(f"sharded fleet over {devs} ("
          f"{'one device named twice' if len(set(devs)) == 1 else 'one slot a card'}): "
          f"every Progress equals the unsharded fleet's bit for bit; "
          f"dispatches {mstats['dispatches']} (unsharded "
          f"{stats['dispatches']}); traces per arch equal; grouped "
          f"dispatch parts a slot (one grouped launch a layer each) "
          f"{mrt.slot_parts['super']}, grouped launches "
          f"{ {k: v for k, v in mlaunches.items() if 'grouped' in k} } "
          f"(unsharded { {k: v for k, v in launches.items() if 'grouped' in k} }); "
          f"fallbacks {mrt.sharding_fallbacks()}; host wall {mwall:.2f} s "
          f"(unsharded {wall:.2f} s)")
    return out


def mesh_devices(device) -> list:
    """The scoring mesh's slots: every card where there are two or more,
    else the one device named twice."""
    n = torch.cuda.device_count() if device.type == "cuda" else 0
    return [f"cuda:{i}" for i in range(n)] if n >= 2 else \
        [str(device) if device.type != "cuda" else "cuda:0"] * 2


class _Trained:
    def __init__(self, arch, params):
        self.arch, self.params = arch, params


class _Bank:
    def __init__(self, crops):
        self._c = crops

    def crops(self, idxs, region, size):
        return self._c[np.asarray(idxs)]


def mesh_probe_phase(device) -> dict:
    """Superbatches on the scoring mesh of n slots (``mesh_devices``):
    groups of n members (split, one a slot) and n + 1 (run whole on slot
    0), each member bit for bit its per-demand scoring, and the one
    fallback recorded exactly (``tests/_sharded_subprocess.py``'s
    check)."""
    devs = mesh_devices(device)
    n = len(devs)
    mesh = make_scoring_mesh(devs)
    rng = np.random.default_rng(7)
    rt = OperatorRuntime(mesh=mesh)
    cuda = device.type == "cuda"
    for g in (n, n + 1):
        demands = []
        for k in range(g):
            a = ops.OperatorArch(f"g{k}", 3, 16, 32, 50)
            p = ops.init_operator(a, torch.Generator().manual_seed(100 + k),
                                  device)
            c = rng.uniform(size=(300, 50, 50, 3)).astype(np.float32)
            demands.append((_Trained(a, p), _Bank(c), np.arange(300)))
        want = [(OperatorRuntime() if cuda else OperatorRuntime(
            device=device)).score_crops(t.params, t.arch, b._c)
            for t, b, _ in demands]
        got = rt.score_demands(demands, group_max=g)
        check(all(np.array_equal(wp, gp) and np.array_equal(wc, gc)
                  for (wp, wc), (gp, gc) in zip(want, got)),
              f"a superbatch of {g} on {devs} differs from per-demand "
              "scoring")
    fb = rt.sharding_fallbacks()
    check([(e["axis"], e["dims"]) for e in fb] == [("group", [n + 1])],
          f"fallbacks {fb}")
    print(f"mesh probe over {devs}: superbatches of {n} (split, parts a "
          f"slot {rt.slot_parts['super']}) and {n + 1} (whole on slot 0) "
          f"bit for bit per-demand scoring; fallbacks {fb}")
    return {"devices": devs, "slot_parts": rt.slot_parts, "fallbacks": fb}


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


def _row(name, what, err, t, bound, by, rel=None):
    row = {"max_abs_err": err, "ms": t["kernel"], "plain_ms": t["plain"],
           "library_ms": t["library"], "bound_ms": bound, "bound_by": by,
           "call_ms": t["call"]}
    if rel is not None:
        row["rel_err"] = rel
    print(f"kernel {name} {what}: max|err| {err:.3e}" +
          (f" ({rel:.3e} of the largest entry)" if rel is not None else "") +
          "  kernel "
          f"{row['ms']:.4f} ms (per call with the host "
          f"{row['call_ms']:.4f} ms)  plain {row['plain_ms']:.4f} ms  library "
          f"{row['library_ms']:.4f} ms  bound {bound:.4f} ms ({by})  "
          f"share of bound {bound / row['ms']:.3f}")
    return row


def lm_kernel_phase(device, arch: str = LM_ARCH, rms_shapes=RMS_SHAPES,
                    flash_shapes=FLASH_SHAPES, decode: bool = True) -> dict:
    """Each attention-model kernel against its plain version at the
    shapes serving ``arch`` gives it (h2o-danube-1.8b: d 2560, 32 query
    heads over 8 kv heads of dim 80, window 4096; granite-moe-3b-a800m:
    d 1536, 24 over 8 of dim 64, no window; 8 slots of 4096 ring rows),
    timed beside the plain version and one PyTorch library call (the
    yardstick, never called by the port); ``decode`` adds the decode
    tick's attention. Returns rows keyed (kernel, label); labels of other
    models than h2o-danube-1.8b name their heads."""
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
        bound, by = _bound(*rms.cost(x.shape, dt), dt)
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
        bound, by = _bound(*fa.cost(q.shape, k.shape, dt, window=W), dt)
        label = f"B=1 S={S}{heads} {str(dt)[6:]}"
        rows[("flash_attention", label)] = _row("flash_attention", label,
                                                err, t, bound, by)
        del q, k, v, qt, kt, vt, band
        torch.cuda.empty_cache()

    if not decode:
        return rows
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
        bound, by = _bound(*da.cost(q.shape, k.shape, dt,
                                    n_valid=int(n_valid.sum())), dt)
        split = da.split_rows(S, D, H // KV, dt)
        label = (f"B=8 S=4096{heads} split {split} pos {pos.tolist()} "
                 f"{str(dt)[6:]}")
        rows[("decode_attention", label)] = _row("decode_attention", label,
                                                 err, t, bound, by)
        del q, k, v, kt, vt
    torch.cuda.empty_cache()
    return rows


def _slice_row(device, q, k, v, tpos, r0, S, dt, label) -> dict:
    """Decode attention over rows ``r0 .. r0 + k.shape[1] - 1`` of rings
    of ``S`` with each head's log-sum-exp, against its plain version,
    timed beside it and SDPA over the slice with its row mask; the row of
    the ``kernels`` line at ``label``."""
    H, S_l = q.shape[1], k.shape[1]
    pos = tpos.long().cpu().numpy()
    n_valid = np.where(pos >= S, S_l, np.clip(pos + 1 - r0, 0, S_l))
    got, lse = da.decode_attention(q, k, v, tpos, row0=r0, rows=S, lse=True)
    want, wlse = ref.decode_attention(q, k, v, tpos, row0=r0, rows=S,
                                      lse=True)
    err = float((got.float() - want.float()).abs().max())
    # bf16's error is its output's rounding, relative to the output, which
    # over a long slice is an average of many rows and small; float32's is
    # the sum's, on the scale of v (1). Either way far below the output,
    # so that zeros, or v summed from the wrong rows, fail.
    scale = float(want.float().abs().max())
    tol = LM_TOL[dt] * (scale if dt == torch.bfloat16 else 1.0)
    check(tol <= 0.1 * scale, f"decode slice {label}: a tolerance of {tol} "
          f"would pass a zero output (max |want| {scale})")
    empty = torch.isinf(wlse)
    check(torch.equal(torch.isinf(lse), empty),
          f"decode slice {label}: the empty slots' log-sum-exp differ")
    lse_err = float((lse[~empty] - wlse[~empty]).abs().max())
    lse_scale = max(1.0, float(wlse[~empty].abs().max()))
    print(f"decode slice {label}: output max |err| {err:.3e} (tolerance "
          f"{tol:.3e}, max |want| {scale:.3e}), log-sum-exp max |err| "
          f"{lse_err:.3e} (max |lse| {lse_scale:.3f})", flush=True)
    check(math.isfinite(err) and err <= tol and
          lse_err <= LSE_TOL * lse_scale,
          f"decode slice {label}: max |err| {err} (tolerance {tol}), lse "
          f"{lse_err}")
    del got, want
    qt = q[:, :, None]
    kt = ref.expand_kv(k, H).transpose(1, 2)
    vt = ref.expand_kv(v, H).transpose(1, 2)
    r = torch.arange(S_l, device=device)[None, :] + r0
    valid = ((r <= tpos[:, None].long()) |
             (tpos[:, None].long() >= S))[:, None, None, :]
    t = _in_turns(lambda: da.decode_attention(q, k, v, tpos, row0=r0,
                                              rows=S, lse=True),
                  lambda: ref.decode_attention(q, k, v, tpos, row0=r0,
                                               rows=S, lse=True),
                  lambda: F.scaled_dot_product_attention(
                      qt, kt, vt, attn_mask=valid),
                  iters=10 if S_l > 8192 else 50)
    bound, by = _bound(*da.cost(q.shape, k.shape, dt,
                                n_valid=int(n_valid.sum()), lse=True), dt)
    return _row("decode_attention slice", label, err, t, bound, by)


def decode_slice_phase(device) -> dict:
    """Decode attention over a slice of each ring, the tick of a cache
    axis (``models/attention.py``): rows S/2 .. S-1 of h2o-danube-1.8b's
    8 rings of 4096 (the slots' positions as ``lm_kernel_phase``'s, so
    some slots have no valid row in the slice), and the whole ring with a
    log-sum-exp asked, whose output must be the same bits as without
    one; then at gemma3-12b's heads (16 on 8 of dim 256, one slot) a
    rank's slices of ``long_500k`` (``CX_SLICES``): 131,072 of 524,288
    global rows (data 2 x model 2) in bf16 with the position inside the
    slice and in float32 past the ring's end, 256 of a 1,024-row window,
    and 4 of it (the 256 ranks of a pod, shorter than the kernel's
    64-row tile) with the position inside. Each slice held to its plain
    version and
    timed beside it and SDPA over the slice with its row mask."""
    cfg = get_config(LM_ARCH)
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    B, S = 8, 4096
    r0 = S // 2
    pos = np.random.default_rng(0).integers(0, S, size=B)
    pos[-1] = S + 904
    tpos = torch.tensor(pos, dtype=torch.int32, device=device)
    rows = {}
    for dt in (torch.bfloat16, torch.float32):
        q = _randn((B, H, D), dt, device, 7)
        k = _randn((B, S, KV, D), dt, device, 8)
        v = _randn((B, S, KV, D), dt, device, 9)
        ks, vs = k[:, r0:].contiguous(), v[:, r0:].contiguous()
        empty = int((np.where(pos >= S, S - r0, pos + 1 - r0) <= 0).sum())
        label = (f"B=8 rows {r0}..{S - 1} of S=4096 pos {pos.tolist()} "
                 f"(empty slots {empty}) {str(dt)[6:]}")
        row = _slice_row(device, q, ks, vs, tpos, r0, S, dt, label)
        # the whole ring: asking for the log-sum-exp keeps the output's bits
        whole = da.decode_attention(q, k, v, tpos)
        same = torch.equal(da.decode_attention(q, k, v, tpos, lse=True)[0],
                           whole)
        check(same, f"decode slice {dt}: the output with a log-sum-exp "
              "differs from the output without one")
        row["lse_keeps_bits"] = same
        rows[("decode_attention_slice", label)] = row
        del q, k, v, ks, vs, whole
    cfg = get_config(CX_ARCH)
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    for sl in CX_SLICES:
        r0, S_l, S, dt, p = sl
        tpos = torch.tensor([p], dtype=torch.int32, device=device)
        q = _randn((1, H, D), dt, device, 17)
        k = _randn((1, S_l, KV, D), dt, device, 18)
        v = _randn((1, S_l, KV, D), dt, device, 19)
        label = cx_slice_label(sl)
        rows[("decode_attention_slice", label)] = _slice_row(
            device, q, k, v, tpos, r0, S, dt, label)
        del q, k, v
    torch.cuda.empty_cache()
    return rows


def moe_kernel_phase(device, arch: str = MOE_ARCH, caps=GMM_CAPS,
                     dims=GMM_DIMS) -> dict:
    """The grouped expert matmul against its plain version at the shapes
    serving ``arch`` gives it (granite-moe-3b-a800m: 40 experts, capacity
    8 in a decode tick, 32 to 512 in a prefill, one ragged, 1536 -> 512
    for the gate and up products, 512 -> 1536 for the down product;
    jamba-v0.1-52b: 16 experts, ``HYBRID_GMM_CAPS`` and
    ``HYBRID_GMM_DIMS``), in bfloat16 and float32, timed beside the plain
    version and one ``torch.bmm`` (the yardstick, never called by the
    port). x has unit entries, as a normed token does, and w the init's
    1/sqrt(fan-in)."""
    E = get_config(arch).num_experts
    rows = {}
    for C in caps:
        for d, f in dims:
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
                bound, by = _bound(*gmm.cost(x.shape, f, dt), dt)
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


def kernels_of(cfg, decode: bool = True) -> set:
    """The LM kernels a forward of ``cfg`` launches: the norms always,
    the attention kernels where a layer attends (decode attention only
    in a decode tick), the expert matmul where a layer is MoE."""
    mixers = {s.mixer for s in cfg.pattern}
    used = {"rmsnorm"}
    if mixers & {"attn", "attn_window"}:
        used |= {"flash_attention", "decode_attention"} if decode else \
            {"flash_attention"}
    if any(s.ffn == "moe" for s in cfg.pattern):
        used.add("moe_gmm")
    return used


def served_config(arch: str, **overrides):
    """``arch``'s published config, its depth cut to ``CUT_LAYERS``."""
    cfg = get_config(arch)
    if arch in CUT_LAYERS:
        overrides = {"num_layers": CUT_LAYERS[arch], **overrides}
    return cfg.scaled(**overrides)


def recurrent(cfg) -> bool:
    return any(s.mixer in ("mamba", "mlstm", "slstm") for s in cfg.pattern)


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
        used = kernels_of(model.cfg, decode=bool(max_new))
        check(all(bool(moved[k]) == (k in used) for k in moved)
              if path == "kernel" else
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
        for b in (b for b in model.blocks if b.attends):
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


def parity_phase(device, arch: str = MOE_ARCH,
                 dtypes=("float32", "bfloat16")) -> dict:
    """``arch`` at full width (jamba-v0.1-52b cut to one period), random
    weights from one CUDA generator seed with unit-variance scores (F3),
    kernel path against plain path, in each of ``dtypes``: the prefill
    logits and the engine's greedy tokens of four prompts (lengths the
    recurrent mixers' chunks take, for a recurrent model). In an MoE
    model a near-tie at the k-th expert can flip a route between two
    computations that differ by rounding, which changes a token's output
    by O(gate weight); so the phase counts the (token, layer) top-k
    expert sets that differ. In float32 at most ``ROUTE_LIMIT`` of them
    may, and the requests whose routes all agree keep their prefill
    logits within 1e-3 and their greedy tokens identical. In bfloat16 it
    reports."""
    out = {}
    for cdt in dtypes:
        cfg = served_config(arch, compute_dtype=cdt)
        lens = RECURRENT_PROMPTS if recurrent(cfg) else (5, 77, 1031, 2047)
        prompts = [np.random.default_rng(s).integers(0, cfg.vocab_size, n)
                   for s, n in enumerate(lens)]
        torch.cuda.reset_peak_memory_stats()
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
        share = sum(diff) / max(sum(total), 1)
        dlogit = (lk - lp).abs().max(dim=-1).values.tolist()
        agree = [sum(a == b for a, b in zip(x, y)) / len(y)
                 for x, y in zip(tk, tp)]
        clean = [r for r in range(len(prompts)) if diff[r] == 0]
        row = {"max_abs_dlogit": max(dlogit),
               "rel_dlogit": max(dlogit) / float(lp.abs().max()),
               "dlogit_by_request": dlogit, "token_agreement_by_request":
               agree, "routes_compared": sum(total),
               "routes_differing": sum(diff), "route_share": share,
               "routes_differing_by_request": diff,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        routes = (f"; top-{cfg.top_k} expert sets differing {sum(diff)} of "
                  f"{sum(total)} (token, layer) routes = {share:.2e}, by "
                  f"request {diff}") if cfg.num_experts else ""
        print(f"parity {arch} {cdt}, unit scores ({cfg.num_layers}L "
              f"d{cfg.d_model}, prompts {list(lens)}, init {t_init:.2f} s, "
              f"peak memory {row['peak_mem_gb']:.2f} GB): prefill "
              f"max|dlogit| by request " +
              " ".join(f"{x:.3e}" for x in dlogit) +
              f", / max|logit| {row['rel_dlogit']:.3e}; greedy tokens "
              f"agree by request {agree}{routes}; kernel {tk[1]} plain "
              f"{tp[1]}")
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


def scan_phase(device) -> dict:
    """The recurrent mixers alone at full width in bfloat16, random
    weights: host wall (each ending in a synchronize) of one mixer's
    prefill of a SCAN_TOKENS-token prompt (jamba's Mamba: 4 chunks of
    the log-depth scan; xlstm's mLSTM: 8 chunks; its sLSTM: 2048 eager
    steps, one a token) and of one decode step of SCAN_SLOTS slots. The
    JAX package computes these with XLA ops and no Pallas kernel, so the
    port's are PyTorch ops and launch none of its kernels."""
    S, B = SCAN_TOKENS, SCAN_SLOTS
    out = {}
    for arch, mixer in ((HYBRID_ARCH, "mamba"), (XLSTM_ARCH, "mlstm"),
                        (XLSTM_ARCH, "slstm")):
        cfg = get_config(arch).scaled(compute_dtype="bfloat16")
        g = torch.Generator(device=device).manual_seed(0)
        w = {n: t if n in tf.FLOAT32_WEIGHTS else t.bfloat16()
             for n, t in tf._draw_mixer(cfg, mixer, g).items()}
        block = tf.recurrent_mixer(cfg, mixer, w)
        x = torch.randn(1, S, cfg.d_model, generator=g, device=device
                        ).bfloat16()
        xt = torch.randn(B, 1, cfg.d_model, generator=g, device=device
                         ).bfloat16()
        cache = next(c for c, spec in zip(
            tf.init_caches(cfg.scaled(num_layers=len(cfg.pattern)), B, 1,
                           device), cfg.pattern) if spec.mixer == mixer)
        before = lm_launches()
        walls = {}
        for name, fn in (("prefill", lambda: block(x)),
                         ("decode", lambda: block.decode(xt, dict(cache)))):
            fn()
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            walls[name] = (time.perf_counter() - t) / 3
        check(lm_launches() == before, f"{mixer} launched an LM kernel")
        row = {"prefill_s": walls["prefill"],
               "prefill_us_per_token": 1e6 * walls["prefill"] / S,
               "decode_ms": 1e3 * walls["decode"]}
        print(f"scan {arch} {mixer} (d{cfg.d_model}, bf16): prefill of "
              f"{S} tokens {row['prefill_s']:.4f} s = "
              f"{row['prefill_us_per_token']:.1f} us a token; decode step "
              f"of {B} slots {row['decode_ms']:.3f} ms (host wall)")
        out[mixer] = row
        del block, w, x, cache
        free_memory()
    return out


def prefix_phase(device, arch: str = VLM_ARCH) -> dict:
    """A frontend model's prefill at full width with its depth cut to
    ``CUT_LAYERS`` (llava-next-34b: 2 of 60 layers, 56/8 heads of 128;
    musicgen-large: 2 of 48, 32/32 of 64), its ``PREFIXES`` prefix
    embeddings before its tokens, kernel path against plain path, random
    weights with unit-variance scores (F3): in float32 the logits within
    1e-3; in bfloat16 reported. Each path's launches are counted over its
    one prefill: the kernel path's norms and flash attention all launch,
    the plain path's none."""
    n_prefix, n_tokens = PREFIXES[arch]
    out = {}
    for cdt in ("float32", "bfloat16"):
        cfg = served_config(arch, compute_dtype=cdt)
        torch.cuda.reset_peak_memory_stats()
        model = tf.init_model(cfg, torch.Generator(device=device)
                              .manual_seed(0), device)
        unit_scores(model)
        g = torch.Generator(device=device).manual_seed(1)
        prefix = torch.randn(1, n_prefix, cfg.d_model, generator=g,
                             device=device)
        tokens = torch.randint(0, cfg.vocab_size, (1, n_tokens),
                               generator=g, device=device)
        res = {}
        for path in ("kernel", "plain"):
            ctx = plain_lm_path() if path == "plain" else \
                contextlib.nullcontext()
            before = lm_launches()
            torch.cuda.synchronize()
            t = time.perf_counter()
            with ctx:
                logits, caches = tf.prefill(model, tokens, prefix)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t
            moved = {k: lm_launches()[k] - v for k, v in before.items()}
            want = {"rmsnorm": 2 * cfg.num_layers + 1,
                    "flash_attention": cfg.num_layers} if path == "kernel" \
                else {}
            check(all(moved[k] == want.get(k, 0) for k in moved),
                  f"{arch} {path} path launches {moved}")
            res[path] = (logits[0, -1].float(), caches, wall, moved)
        (lk, ck, wk, launches), (lp, cp, wp, _) = res["kernel"], \
            res["plain"]
        S = n_prefix + n_tokens
        check(bool(torch.isfinite(lk).all()) and
              lk.shape == (cfg.vocab_size,) and ck[0]["k"].shape[1] == S,
              f"{arch} {cdt}: logits {tuple(lk.shape)}, k cache "
              f"{tuple(ck[0]['k'].shape)}")
        dlogit = float((lk - lp).abs().max())
        dk = [float((a["k"].float() - b["k"].float()).abs().max())
              for a, b in zip(ck, cp)]
        row = {"max_abs_dlogit": dlogit,
               "rel_dlogit": dlogit / float(lp.abs().max()),
               "max_abs_dk_by_layer": dk, "kernel_wall_s": wk,
               "plain_wall_s": wp, "launches": launches,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        print(f"prefill {arch} {cdt}, unit scores ({cfg.num_layers} of "
              f"{get_config(arch).num_layers}L d{cfg.d_model}, "
              f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
              f"{cfg.resolved_head_dim}; {n_prefix} prefix embeddings + "
              f"{n_tokens} tokens): max|dlogit| {dlogit:.3e}, "
              f"/ max|logit| {row['rel_dlogit']:.3e}; max|dk| by layer "
              + " ".join(f"{x:.1e}" for x in dk) +
              f"; host wall kernel path {wk:.3f} s, plain {wp:.3f} s; "
              f"launches {launches}; peak memory {row['peak_mem_gb']:.2f} GB")
        if cdt == "float32":
            check(dlogit <= LOGIT_TOL, f"{arch} float32 logits differ by "
                  f"{dlogit}")
        out[cdt] = row
        del model, res, ck, cp
        free_memory()
    return out


# -- phase 7: the LM main path, serving a model ------------------------------

def serve_phase(device, trace: bool = False, arch: str = LM_ARCH) -> dict:
    """16 requests submitted at once to ``ServeEngine`` (8 slots, 4096
    ring rows) serving the published ``arch`` (h2o-danube-1.8b,
    granite-moe-3b-a800m, jamba-v0.1-52b cut to one period, xlstm-125m;
    bfloat16) with random weights: prompts of 128-2048 tokens (for a
    recurrent model 128-256 tokens or one of ``RECURRENT_LONG``, lengths
    its scans' chunks take), ``SERVE_NEW`` greedy tokens each. Host wall
    of each prefill and each decode tick (each ends in the sampler's copy
    to the host, so the card has finished), time to first token per
    request, and the
    LM kernels' launches: the model's kernels all launched and no other,
    the grouped expert matmul 3 times per MoE layer per forward."""
    cfg = served_config(arch)
    torch.cuda.reset_peak_memory_stats()
    model = tf.init_model(cfg, torch.Generator(device=device).manual_seed(0),
                          device)
    rng = np.random.default_rng(0)
    if recurrent(cfg):
        lens = np.where(rng.random(16) < 0.5, rng.integers(128, 257, 16),
                        rng.choice(RECURRENT_LONG, 16))
    else:
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
    rids = [eng.submit(p, max_new=SERVE_NEW) for p in prompts]
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
        # the wall ends here: the profiler's exit then processes its trace
        t_wall = time.perf_counter() - t0
    launches = lm_launches()
    check(sorted(res) == sorted(rids) and
          all(len(res[r]) == SERVE_NEW for r in rids),
          "not every request finished")
    check(all(0 <= t < cfg.vocab_size for r in rids for t in res[r]),
          "a token outside the vocabulary")
    n_moe = sum(cfg.pattern[i % len(cfg.pattern)].ffn == "moe"
                for i in range(cfg.num_layers))
    forwards = len(first) + wall["ticks"]
    used = kernels_of(cfg)
    check(all(bool(v) == (k in used) for k, v in launches.items()) and
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
    # the wrapped methods and the engine refer to each other through these
    # names' cells: clearing them frees the model now, not at the next
    # collection
    del eng, model, prefill_into, tick
    free_memory()
    return out


# -- phase 9: training: the backward kernels, parity, steps, resume --------


def train_launches():
    """Forward and backward launches of the training path's kernels."""
    return {"rmsnorm": rms.rmsnorm.launches,
            "rmsnorm_bwd": rms.rmsnorm_bwd.launches,
            "flash_attention": fa.flash_attention.launches,
            "flash_attention_bwd": fa.flash_attention_bwd.launches,
            "moe_gmm": gmm.moe_gmm.launches,
            "moe_gmm_bwd": gmm.moe_gmm_bwd.launches}


def zero_train_launches():
    for f in (rms.rmsnorm, rms.rmsnorm_bwd, fa.flash_attention,
              fa.flash_attention_bwd, gmm.moe_gmm, gmm.moe_gmm_bwd):
        f.launches = 0


def _abs_err(got, want) -> float:
    return max(float((a.float() - b.float()).abs().max())
               for a, b in zip(got, want))


def _rel_err(got, want) -> float:
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    return max(float((a.float() - b.float()).abs().max()) /
               max(float(b.float().abs().max()), 1e-30)
               for a, b in zip(got, want))


def _library_grad(fn, inputs, dout):
    """One autograd call of a PyTorch library forward (the yardstick):
    its graph built once, its backward timed."""
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*ins)
    return lambda: torch.autograd.grad(out, ins, dout, retain_graph=True)


def _gmm_bwd_on_copies(x, w, dy):
    """dx and dw by the forward kernel on explicit transposed copies, C
    padded with zero rows to a multiple of 8 for dw: the backward before
    it read its operands in place."""
    pad = -x.shape[1] % 8
    xt = F.pad(x, (0, 0, 0, pad)).transpose(1, 2).contiguous()
    return (gmm._product(dy, w.transpose(1, 2).contiguous()),
            gmm._product(xt, F.pad(dy, (0, 0, 0, pad))))


def gmm_bwd_kernels(x, w, dy) -> list:
    """``moe_gmm_bwd``'s no-copy check: one call, captured into a CUDA graph
    (``build.graph_kernels``), is its two GEMM launches and nothing else:
    no copy, pad or transpose kernel, no memcpy or memset."""
    tag = "gmm_wgmma" if x.dtype == torch.bfloat16 else "gmm_tile"
    names = build.graph_kernels(lambda: gmm.moe_gmm_bwd(x, w, dy))
    check(len(names) == 2 and all(tag in n for n in names),
          f"moe_gmm_bwd {x.dtype} launched {names}")
    return [demangle(names)[n].split("(")[0] for n in names]


def _gmm_bwd_against_copies(x, w, dy, got) -> dict:
    """``moe_gmm_bwd``'s bits against the forward kernel on explicit
    transposed and padded copies (the earlier design), and that path's
    device time."""
    copies = _gmm_bwd_on_copies(x, w, dy)
    out = {"copies_bits_equal": all(torch.equal(a, b)
                                    for a, b in zip(got, copies)),
           "copies_max_diff": _abs_err(got, copies),
           "copies_ms": time_ms(lambda: _gmm_bwd_on_copies(x, w, dy),
                                iters=10, lead_cycles=LEAD_CYCLES)}
    del copies
    return out


def granite_steps(device, n_steps, adamw, true_fan_in=False):
    """``n_steps`` AdamW steps of granite-moe-3b-a800m at full width cut to
    2 layers (bf16 compute, float32 parameters), as ``launch.train`` takes
    them: the seed-0 model (wq and wk at their true fan-in if asked,
    ``unit_scores``), the synthetic pipeline at 4 x 1024 tokens,
    ``make_train_step`` in ``train_step.deterministic``. Returns the model
    after the last step and each step's loss and gradient norm, on the
    host."""
    from repro_torch.train import data as data_mod
    cfg = served_config(TRAIN_ARCH, num_layers=2)
    model = tf.init_model(cfg, torch.Generator(device=device).manual_seed(0),
                          device, trainable=True)
    if true_fan_in:
        unit_scores(model)
    ostate = opt.init_opt_state(dict(model.named_parameters()))
    pipe = data_mod.TokenPipeline(data_mod.DataConfig(
        vocab_size=cfg.vocab_size, batch=TRAIN_BATCH, seq_len=TRAIN_SEQ))
    step = steps.make_train_step(cfg, adamw)
    losses, norms = [], []
    with steps.deterministic():
        for i in range(n_steps):
            model, ostate, metrics = step(model, ostate, pipe.batch_at(i))
            losses.append(metrics["loss"].cpu())
            norms.append(metrics["grad_norm"].cpu())
    del ostate
    return model, torch.stack(losses), torch.stack(norms)


def step_bits_phase(device) -> dict:
    """``STEP_BITS_STEPS`` steps of ``granite_steps``: each step's loss and
    gradient norm and every parameter after the last step, on the host.
    Run once before every other phase and once after them, the two must
    agree bit for bit: a training step's bits may not follow what the
    process ran before (F9 showed after the first step)."""
    model, losses, norms = granite_steps(
        device, STEP_BITS_STEPS, opt.AdamWConfig(total_steps=STEP_BITS_STEPS))
    out = {"losses": losses, "norms": norms,
           "params": {n: p.detach().cpu()
                      for n, p in model.named_parameters()}}
    del model
    free_memory()
    return out


def learn_phase(device) -> dict:
    """Training learns on the card at full width: ``LEARN_STEPS`` steps of
    ``granite_steps`` with wq and wk at their true fan-in (at the JAX init
    scale the gradient norm is about 2e15 and clipping leaves no update,
    F3), AdamW at lr 1e-3 after 3 warm-up steps, every forward and
    backward kernel of the path launched. Every loss and gradient norm is
    printed; the mean loss of the last ``LEARN_WINDOW`` steps must be at
    least ``LEARN_DROP`` below that of the first."""
    zero_train_launches()
    t0 = time.perf_counter()
    model, losses, norms = granite_steps(
        device, LEARN_STEPS, opt.AdamWConfig(lr=1e-3, warmup_steps=3,
                                             total_steps=LEARN_STEPS),
        true_fan_in=True)
    del model
    launches = train_launches()
    losses, norms = losses.tolist(), norms.tolist()
    first = float(np.mean(losses[:LEARN_WINDOW]))
    last = float(np.mean(losses[-LEARN_WINDOW:]))
    out = {"losses": losses, "grad_norms": norms, "first_mean": first,
           "last_mean": last, "drop": first - last, "launches": launches,
           "wall_s": time.perf_counter() - t0}
    print(f"learn {TRAIN_ARCH} (2 of 32 layers at full width, wq and wk at "
          f"their true fan-in, bf16 compute, AdamW lr 1e-3, "
          f"{LEARN_STEPS} steps of {TRAIN_BATCH}x{TRAIN_SEQ}): losses " +
          " ".join(f"{x:.4f}" for x in losses) + "; gradient norms " +
          " ".join(f"{x:.4g}" for x in norms) +
          f"; mean of the first {LEARN_WINDOW} {first:.4f}, of the last "
          f"{LEARN_WINDOW} {last:.4f}, drop {first - last:.4f} (at least "
          f"{LEARN_DROP}); launches {launches}; {out['wall_s']:.1f} s")
    check(all(map(math.isfinite, losses)), f"losses {losses}")
    check(all(launches.values()), f"a training kernel never ran: {launches}")
    check(first - last >= LEARN_DROP,
          f"the loss fell by {first - last:.4f}, less than {LEARN_DROP}")
    free_memory()
    return out


def same_step_bits(early: dict, late: dict) -> dict:
    differ = [n for n, p in early["params"].items()
              if not torch.equal(p, late["params"][n])]
    out = {"steps": STEP_BITS_STEPS, "parameters": len(early["params"]),
           "differing": differ,
           "losses_equal": bool(torch.equal(early["losses"],
                                            late["losses"])),
           "norms_equal": bool(torch.equal(early["norms"], late["norms"]))}
    print(f"training step bits (granite 2 of 32 layers, bf16 compute, "
          f"{STEP_BITS_STEPS} AdamW steps of 4x1024), before every other "
          f"phase against after them: losses "
          f"{early['losses'].tolist()} equal {out['losses_equal']}; "
          f"gradient norms {early['norms'].tolist()} equal "
          f"{out['norms_equal']}; {len(differ)} of {out['parameters']} "
          f"parameters differ after the last step {differ[:8]}")
    check(out["losses_equal"] and out["norms_equal"] and not differ,
          "a training step's bits follow the process's history")
    return out


def rms_bwd_row(device, R, d, dt) -> dict:
    """rmsnorm's backward over R rows of d: against ``ref.rmsnorm_bwd``
    within ``BWD_TOL``, a second launch bit for bit the first, one call one
    kernel (the cooperative launch: one node of a CUDA graph, no memset or
    copy), timed beside the plain version and ``F.rms_norm``'s backward;
    the bound is x and dy read and dx written once (the partial rows of
    dscale are the design's own traffic, not counted)."""
    name = str(dt)[6:]
    x = _randn((R, d), dt, device, 1) * 3
    scale = 1 + 0.1 * _randn((d,), torch.float32, device, 2)
    dy = _randn((R, d), dt, device, 3)
    got = rms.rmsnorm_bwd(x, scale, dy)
    want = ref.rmsnorm_bwd(x, scale, dy)
    err, aerr = _rel_err(got, want), _abs_err(got, want)
    again = rms.rmsnorm_bwd(x, scale, dy)
    check(err <= BWD_TOL[dt] and all(torch.equal(a, b) for a, b in
                                     zip(got, again)),
          f"rmsnorm_bwd {R}x{d} {dt}: rel err {err}, bits repeat "
          f"{[torch.equal(a, b) for a, b in zip(got, again)]}")
    nodes = build.graph_kernels(lambda: rms.rmsnorm_bwd(x, scale, dy))
    check(len(nodes) == 1 and "rmsnorm_bwd_kernel" in nodes[0],
          f"rmsnorm_bwd {R}x{d} {dt}: one call puts {nodes} in a graph")
    t = _in_turns(lambda: rms.rmsnorm_bwd(x, scale, dy),
                  lambda: ref.rmsnorm_bwd(x, scale, dy),
                  _library_grad(lambda a, w: F.rms_norm(a, (d,), w, 1e-6),
                                (x, scale.to(dt)), dy), iters=20)
    bound, by = _bound(*rms.bwd_cost(x.shape, dt), dt)
    label = f"{R}x{d} {name}"
    print(f"rmsnorm_bwd {label}: one call is one kernel node "
          f"({demangle(nodes)[nodes[0]].split('(')[0]})")
    return {("rmsnorm_bwd", label): _row("rmsnorm_bwd", label, aerr, t,
                                         bound, by, rel=err) |
            {"graph_nodes": len(nodes)}}


def bwd_kernel_phase(device) -> dict:
    """Each backward kernel against its plain version at the training
    shapes (``ref.rmsnorm_bwd``, ``ref.attention_bwd``,
    ``ref.moe_gmm_bwd``), float32 within ``BWD_TOL`` and bfloat16 within
    2e-2 relative to the largest entry, a second launch bit for bit the
    first (no atomics), timed beside the plain version and the library's
    backward (``F.rms_norm``'s, SDPA's, ``torch.bmm``'s, by one
    ``torch.autograd.grad`` call). rmsnorm's backward also at xlstm-125m's
    and h2o-danube-1.8b's widths (``RMS_BWD_WIDTHS``), each call one
    kernel (``rms_bwd_row``). ``moe_gmm_bwd`` also launches its two
    GEMM kernels and nothing else (``gmm_bwd_kernels``), and is compared
    bit for bit with, and timed beside, the forward kernel on transposed,
    padded copies."""
    cfg = get_config(TRAIN_ARCH)
    d, H, KV, D = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                   cfg.resolved_head_dim)
    rows = {}
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt)[6:]
        R = TRAIN_BATCH * TRAIN_SEQ
        for width in (d,) + RMS_BWD_WIDTHS:
            rows.update(rms_bwd_row(device, R, width, dt))
        for B, S, h, kv, hd, W in ((TRAIN_BATCH, TRAIN_SEQ, H, KV, D, None),
                                   (1, 4096, 32, 8, 80, 4096)):
            q = _randn((B, S, h, hd), dt, device, 4)
            k = _randn((B, S, kv, hd), dt, device, 5)
            v = _randn((B, S, kv, hd), dt, device, 6)
            do = _randn((B, S, h, hd), dt, device, 7)
            out, lse = fa._forward(q, k, v, True, W, 0, True)
            got = fa.flash_attention_bwd(q, k, v, out, lse, do, window=W)
            want = ref.attention_bwd(q, k, v, out, do, window=W)
            err, aerr = _rel_err(got, want), _abs_err(got, want)
            again = fa.flash_attention_bwd(q, k, v, out, lse, do, window=W)
            check(err <= BWD_TOL[dt] and all(torch.equal(a, b) for a, b in
                                             zip(got, again)),
                  f"flash_attention_bwd B={B} S={S} {h}/{kv}x{hd} {dt}: "
                  f"rel err {err}")
            del got, want, again
            torch.cuda.empty_cache()
            g = h // kv

            def sdpa(a, b, c, W=W):
                a, b, c = (t.transpose(1, 2) for t in (
                    a, b.repeat_interleave(g, 2), c.repeat_interleave(g, 2)))
                if W is None or S <= W:
                    o = F.scaled_dot_product_attention(a, b, c,
                                                       is_causal=True)
                else:
                    o = F.scaled_dot_product_attention(
                        a, b, c, attn_mask=ref.keep_mask(S, S, True, W, 0,
                                                         device))
                return o.transpose(1, 2)

            t = _in_turns(
                lambda: fa.flash_attention_bwd(q, k, v, out, lse, do,
                                               window=W),
                lambda: ref.attention_bwd(q, k, v, out, do, window=W),
                _library_grad(sdpa, (q, k, v), do), iters=3)
            bound, by = _bound(*fa.bwd_cost(q.shape, k.shape, dt, window=W),
                               dt)
            label = f"B={B} S={S} {h}/{kv}x{hd}" + \
                (f" window {W}" if W else "") + f" {name}"
            rows[("flash_attention_bwd", label)] = _row(
                "flash_attention_bwd", label, aerr, t, bound, by, rel=err)
            del q, k, v, do, out, lse
            torch.cuda.empty_cache()
        E, C, f = cfg.num_experts, TRAIN_BATCH * TRAIN_SEQ * cfg.top_k * \
            cfg.capacity_factor // cfg.num_experts, cfg.resolved_d_ff_expert
        C = max(8, int(C))
        for a, b in ((d, f), (f, d)):
            x = _randn((E, C, a), dt, device, 8)
            w = (_randn((E, a, b), torch.float32, device, 9) / a ** 0.5).to(dt)
            dy = _randn((E, C, b), dt, device, 10)
            got = gmm.moe_gmm_bwd(x, w, dy)
            want = ref.moe_gmm_bwd(x, w, dy)
            err, aerr = _rel_err(got, want), _abs_err(got, want)
            del want
            again = gmm.moe_gmm_bwd(x, w, dy)
            check(err <= BWD_TOL[dt] and all(torch.equal(p, r) for p, r in
                                             zip(got, again)),
                  f"moe_gmm_bwd E={E} C={C} {a}->{b} {dt}: rel err {err}")
            extra = _gmm_bwd_against_copies(x, w, dy, got)
            extra["kernels"] = gmm_bwd_kernels(x, w, dy)
            print(f"moe_gmm_bwd E={E} C={C} {a}->{b} {name}: one call "
                  f"launches {extra['kernels']} and nothing else; dx, dw bit "
                  f"for bit the forward kernel's on transposed, padded "
                  f"copies: {extra['copies_bits_equal']} (max|diff| "
                  f"{extra['copies_max_diff']:.3e}); that path "
                  f"{extra['copies_ms']:.4f} ms")
            t = _in_turns(lambda: gmm.moe_gmm_bwd(x, w, dy),
                          lambda: ref.moe_gmm_bwd(x, w, dy),
                          _library_grad(torch.bmm, (x, w), dy), iters=10)
            # x, w and dy read once, dx and dw written once
            bound, by = _bound(*gmm.bwd_cost(x.shape, b, dt), dt)
            label = f"E={E} C={C} {a}->{b} {name}"
            rows[("moe_gmm_bwd", label)] = _row("moe_gmm_bwd", label, aerr,
                                                t, bound, by, rel=err) | extra
            del x, w, dy, got, again
    torch.cuda.empty_cache()
    return rows


def _loss_and_grads(model, batch):
    for p in model.parameters():
        p.grad = None
    loss = tf.train_loss(model, batch)
    loss.backward()
    grads = {n: p.grad.detach().clone() for n, p in model.named_parameters()}
    for p in model.parameters():
        p.grad = None
    return loss.detach(), grads


def train_parity_phase(device) -> dict:
    """granite-moe-3b-a800m at full width cut to 2 layers, float32 (the
    parameters and the compute), wq and wk at their true fan-in (F3), one
    batch of 4 x 1024 tokens: the loss, the global gradient norm and every
    gradient of the kernel path (the forward kernels and their backward
    kernels) against the plain path (autograd of the plain forwards). At
    most ``ROUTE_LIMIT`` of the top-8 routes may differ (F4); the loss
    within 1e-4, the norm and each gradient within ``TRAIN_GRAD_TOL`` of
    the plain path relative to its largest entry."""
    cfg = served_config(TRAIN_ARCH, num_layers=2, compute_dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    model = tf.init_model(cfg, torch.Generator(device=device).manual_seed(0),
                          device, trainable=True)
    unit_scores(model)
    rng = np.random.default_rng(0)
    batch = steps.to_batch({
        "tokens": rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ)),
        "labels": rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ))},
        device)
    runs = {}
    for path in ("kernel", "plain"):
        ctx = plain_lm_path() if path == "plain" else contextlib.nullcontext()
        log, label = [], [("prefill", 0)]
        zero_train_launches()
        with ctx, recorded_routes(log, label), steps.deterministic():
            loss, grads = _loss_and_grads(model, batch)
        runs[path] = (loss, grads, log, train_launches())
    (lk, gk, rk, nk), (lp, gp, rp, np_) = runs["kernel"], runs["plain"]
    check(all(nk[k] for k in nk) and not any(np_.values()),
          f"launches: kernel path {nk}, plain path {np_}")
    diff, total = route_diffs(rk, rp, 1)
    share = sum(diff) / max(sum(total), 1)
    norms = [float(opt.global_norm(g)) for g in (gk, gp)]
    errs = {n: _rel_err(gk[n], gp[n]) for n in gk}
    worst = max(errs, key=errs.get)
    out = {"loss": float(lk), "loss_plain": float(lp),
           "dloss": abs(float(lk) - float(lp)), "grad_norm": norms[0],
           "grad_norm_plain": norms[1], "max_rel_grad_err": errs[worst],
           "worst_grad": worst, "routes_compared": sum(total),
           "routes_differing": sum(diff), "launches": nk,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(f"train parity {TRAIN_ARCH} float32 (2 of 32 layers, d"
          f"{cfg.d_model}, batch {TRAIN_BATCH}x{TRAIN_SEQ}): loss "
          f"{out['loss']:.6f} vs plain {out['loss_plain']:.6f}; grad norm "
          f"{norms[0]:.6f} vs {norms[1]:.6f}; worst gradient {worst} rel "
          f"err {errs[worst]:.3e} over {len(errs)} tensors; top-"
          f"{cfg.top_k} sets differing {sum(diff)} of {sum(total)}; "
          f"kernel launches {nk}; peak {out['peak_mem_gb']:.2f} GB")
    check(share <= ROUTE_LIMIT, f"{share:.2e} of the routes differ")
    check(out["dloss"] <= 1e-4, f"loss differs by {out['dloss']}")
    check(abs(norms[0] - norms[1]) <= TRAIN_GRAD_TOL * norms[1],
          f"grad norms {norms}")
    check(errs[worst] <= TRAIN_GRAD_TOL, f"gradient {worst}: {errs[worst]}")
    del model, runs, gk, gp
    free_memory()
    return out


def train_phase(device) -> dict:
    """granite-moe-3b-a800m at its published config (32 layers, float32
    parameters, bf16 compute, remat), ``TRAIN_STEPS`` AdamW steps at batch
    4 x 1024 through ``repro_torch.launch.train``: a finite loss at every
    step, ms a step and tokens/s, peak memory, each kernel's forward and
    backward launches (every one launched), and the last step traced for
    the card's busy share and its largest device operations."""
    from repro_torch.launch import train as launch_train
    traced = {}

    @contextlib.contextmanager
    def trace_last(step):
        if step != TRAIN_STEPS - 1:
            yield
            return
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with prof:
            yield
            torch.cuda.synchronize()
            traced["wall_s"] = time.perf_counter() - t0
        traced["prof"] = prof

    free_memory()
    torch.cuda.reset_peak_memory_stats()
    zero_train_launches()
    t0 = time.perf_counter()
    run = launch_train.run(
        ["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
         str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--log-every", "1"],
        wrap_step=trace_last)
    wall = time.perf_counter() - t0
    launches = train_launches()
    losses, step_s = run["losses"], run["step_s"]
    check(run["steps"] == TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"losses {losses}")
    check(all(launches.values()), f"a training kernel never ran: {launches}")
    untraced = step_s[1:-1]          # the first step warms up, the last traced
    busy = device_busy(traced["prof"], (
        ("rmsnorm", "rmsnorm_rows"), ("rmsnorm_bwd", "rmsnorm_bwd"),
        ("flash_attention", "flash_fwd"), ("flash_attention_bwd",
                                           "flash_bwd"),
        ("moe_gmm", "gmm_")))
    out = {"steps": run["steps"], "losses": losses, "step_s": step_s,
           "ms_per_step": 1e3 * float(np.median(untraced)),
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ / float(np.median(
               untraced)), "wall_s": wall, "launches": launches,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "traced_step_s": traced["wall_s"], **busy}
    if "device_busy_s" in busy:
        out["busy_share"] = busy["device_busy_s"] / traced["wall_s"]
    print(f"train {TRAIN_ARCH} (32L d1536, float32 parameters, bf16 compute, "
          f"remat; batch {TRAIN_BATCH}x{TRAIN_SEQ}): losses " +
          " ".join(f"{x:.4f}" for x in losses) +
          f"; {out['ms_per_step']:.1f} ms a step (median of steps 2-"
          f"{TRAIN_STEPS - 1}), {out['tokens_per_s']:.1f} tokens/s; peak "
          f"memory {out['peak_mem_gb']:.2f} GB; launches {launches}; "
          f"traced step {traced['wall_s']:.3f} s, busy " +
          (f"{out['busy_share']:.4f}" if "busy_share" in out else
           "not measured") +
          f"; top device operations {busy.get('top_kernels')}")
    del run, traced
    free_memory()
    return out


def resume_phase(device) -> dict:
    """xlstm-125m whole through ``repro_torch.launch.train`` with a
    checkpoint directory: ``RESUME_STEPS`` steps straight; then the same
    run preempted by SIGTERM after half of them (it checkpoints and
    exits), and ``--resume auto`` for the rest in a new process, as a
    preempted job restarts. Every saved parameter and optimizer moment of
    the two final checkpoints is bit for bit the same."""
    from repro_torch.launch import train as launch_train
    args = ["--arch", RESUME_ARCH, "--steps", str(RESUME_STEPS), "--batch",
            str(RESUME_BATCH), "--seq", str(RESUME_SEQ), "--ckpt-every",
            "1000", "--log-every", "1000"]
    half = RESUME_STEPS // 2

    @contextlib.contextmanager
    def preempt(step):
        yield
        if step == half - 1:
            os.kill(os.getpid(), signal.SIGTERM)

    def final(path):
        root = Path(path) / (Path(path) / "LATEST").read_text()
        manifest = json.loads((root / "manifest.json").read_text())
        return manifest, {k: np.load(root / v["file"])
                          for k, v in manifest["leaves"].items()}

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        straight = launch_train.run(args + ["--ckpt", a])
        first = launch_train.run(args + ["--ckpt", b], wrap_step=preempt)
        second = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", *args,
             "--ckpt", b, "--resume", "auto"], capture_output=True,
            text=True, timeout=600,
            env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        (ma, la), (mb, lb) = final(a), final(b)
        same = sorted(k for k in la if np.array_equal(la[k], lb.get(k)))
    check(second.returncode == 0 and
          f"resumed at step {half}" in second.stdout,
          f"the resumed process: rc {second.returncode}, "
          f"{second.stdout[-500:]} {second.stderr[-2000:]}")
    check(first["stopped"] and first["steps"] == half,
          f"preempted after {first['steps']} steps")
    check(set(la) == set(lb) and len(same) == len(la),
          f"{len(la) - len(same)} of {len(la)} saved leaves differ")
    check(first["losses"] == straight["losses"][:half],
          "the preempted run's losses differ")
    out = {"leaves": len(la), "identical": len(same),
           "losses": straight["losses"], "wall_s": time.perf_counter() - t0,
           "step_s": straight["step_s"]}
    print(f"resume {RESUME_ARCH} (12L d768, batch {RESUME_BATCH}x"
          f"{RESUME_SEQ}): {RESUME_STEPS} steps straight against {half} "
          f"steps, SIGTERM, and --resume auto for {half} in a new process: "
          f"{len(same)} of {len(la)} saved leaves (parameters, moments, "
          f"step) bit for bit; losses " +
          " ".join(f"{x:.4f}" for x in straight["losses"]) +
          f"; {1e3 * float(np.median(straight['step_s'][1:])):.1f} ms a "
          f"step; {out['wall_s']:.1f} s for the three runs")
    free_memory()
    return out


# -- phase 9: data-parallel training over torch.distributed: FSDP over "data"

def dp_config(smoke: bool, **overrides):
    """granite-moe-3b-a800m at full width, 2 layers (``smoke``: its smoke
    config, for a rehearsal on the CPU), and the sequence length."""
    from repro_torch.configs.base import get_smoke_config
    if smoke:
        return get_smoke_config(TRAIN_ARCH).scaled(**overrides), 32
    return served_config(TRAIN_ARCH, num_layers=2, **overrides), TRAIN_SEQ


def dp_model(cfg, device, mesh=None):
    """The seed-0 model with wq and wk at their true fan-in (F3): this
    rank's slices of ``mesh``'s data axis (FSDP) where it spans
    processes, else the whole."""
    model = tf.init_model(cfg, torch.Generator(device=device).manual_seed(0),
                          device, trainable=True, mesh=mesh)
    unit_scores(model)
    return model


def dp_parity_batch(cfg, seq) -> dict:
    """``train_parity_phase``'s global batch: random tokens and labels."""
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, seq)),
            "labels": rng.integers(0, cfg.vocab_size, (TRAIN_BATCH, seq))}


def dp_f32_step(device, mesh, smoke: bool) -> dict:
    """One float32 step's loss, gradients (this rank's slices under FSDP)
    and routes of ``dp_parity_batch`` (this rank's rows with a mesh over
    processes; all of it otherwise). Under FSDP also whether each
    gradient slice is bit for bit the slice of the same step's whole
    gradients summed by ``sum_gradients`` (the whole model, every weight
    on every rank, on the same rows)."""
    cfg, seq = dp_config(smoke, compute_dtype="float32")
    model = dp_model(cfg, device, mesh)
    batch = dp_parity_batch(cfg, seq)
    log, label = [], [("prefill", 0)]
    with recorded_routes(log, label), steps.deterministic():
        loss, grads = steps.loss_and_grads(model, batch, mesh)
    out = {"loss": loss.cpu(), "routes": [r.cpu() for _, r in log],
           "grads": {n: g.cpu() for n, g in grads.items()},
           "data_dims": dict(model.data_dims)}
    if model.data_dims:
        whole = dp_model(cfg, device)
        with steps.deterministic():
            _, ref = steps.loss_and_grads(whole, batch, mesh)
        out["slices_equal"] = all(torch.equal(g, model.slice_of(n, ref[n]))
                                  for n, g in grads.items())
        del whole, ref
    del model, grads
    free_memory()
    return out


def ranks_agree(model, group, keep=None) -> bool:
    """Every parameter, gathered in rank order where it is sliced over
    the data axis, bit for bit the same on every rank of ``group``; each
    gathered parameter copied to the CPU into ``keep`` when given (one
    at a time, so the card never holds the whole model for it)."""
    same = True
    for n, p in model.named_parameters():
        w = p.detach()
        if n in model.data_dims:
            w = torch.cat(pops.all_parts(w, group), dim=model.data_dims[n])
        parts = pops.all_parts(w, group)
        same &= all(torch.equal(parts[0], q) for q in parts[1:])
        if keep is not None:
            keep[n] = w.cpu()
        del w, parts
    return same


def step_gap(got: dict, want: dict) -> dict:
    """Parameters ``got`` against ``want`` (by name, the same shapes and
    types): the elements that differ, of how many, the largest
    difference, and the largest in units in the last place of the
    parameter's type at ``want``'s value."""
    differing = total = 0
    worst = ulps = 0.0
    for n, b in want.items():
        a = got[n]
        d = (a.double() - b.double()).abs()
        info = torch.finfo(b.dtype)
        place = info.eps * torch.exp2(torch.floor(torch.log2(
            b.double().abs().clamp_min(info.tiny))))
        differing += int((a != b).sum())
        total += b.numel()
        worst = max(worst, float(d.max()))
        ulps = max(ulps, float((d / place).max()))
        del d, place
    return {"differing": differing, "elements": total, "max_abs": worst,
            "max_ulps": ulps}


@contextlib.contextmanager
def timed_collectives(sync, spent=None):
    """Host seconds inside the data axis's collectives (FSDP's gathers
    and reduce-scatters, the loss's and router statistics' sums, the
    gradient norm's, the decode merge's: ``parallel/ops._parts``) and
    inside ``sum_gradients``, each ending in a synchronise, appended to
    the yielded list (``spent``, a new one by default)."""
    spent = [] if spent is None else spent
    parts, summed = pops._parts, steps.sum_gradients

    def timed(fn):
        def call(*args, **kwargs):
            sync()
            t = time.perf_counter()
            res = fn(*args, **kwargs)
            sync()
            spent.append(time.perf_counter() - t)
            return res
        return call

    pops._parts, steps.sum_gradients = timed(parts), timed(summed)
    try:
        yield spent
    finally:
        pops._parts, steps.sum_gradients = parts, summed


def dp_steps(device, mesh, n_steps: int, smoke: bool, keep: bool,
             whole: bool = False, first: bool = False) -> dict:
    """``n_steps`` bf16 AdamW steps (``granite_steps``' run, wq and wk at
    their true fan-in) through ``make_train_step(..., mesh)``, the model
    sliced over the mesh's data axis (FSDP) unless ``whole`` (every
    weight on every rank, every gradient summed by ``sum_gradients``:
    the replicated placement): each step's loss, gradient norm, learning
    rate, host seconds (ending in a synchronise) and host seconds inside
    the data axis's collectives, whether the ranks' gathered parameters
    agree after it, and the process's peak memory on the card; the
    parameters after the last step if ``keep``; the gathered parameters
    after the first step, on the CPU, if ``first`` (``ranks_agree``'s
    copies: a mesh over processes only)."""
    from repro_torch.train import data as data_mod
    cfg, seq = dp_config(smoke)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    model = dp_model(cfg, device, None if whole else mesh)
    ostate = opt.init_opt_state(dict(model.named_parameters()))
    pipe = data_mod.TokenPipeline(data_mod.DataConfig(
        vocab_size=cfg.vocab_size, batch=TRAIN_BATCH, seq_len=seq))
    step = steps.make_train_step(cfg, opt.AdamWConfig(total_steps=n_steps),
                                 mesh)
    out = {"losses": [], "norms": [], "lrs": [], "step_s": [], "coll_s": [],
           "agree": []}
    with steps.deterministic():
        for i in range(n_steps):
            with timed_collectives(sync) as spent:
                sync()
                t = time.perf_counter()
                model, ostate, met = step(model, ostate, pipe.batch_at(i))
                out["losses"].append(met["loss"].cpu())
                out["norms"].append(met["grad_norm"].cpu())
                out["lrs"].append(met["lr"].cpu())
                sync()
                out["step_s"].append(time.perf_counter() - t)
            out["coll_s"].append(sum(spent))
            kept = {} if first and i == 0 else None
            out["agree"].append(mesh is None or mesh.group is None or
                                ranks_agree(model, mesh.group, kept))
            if kept:
                out["first"] = kept
    out["peak_bytes"] = torch.cuda.max_memory_allocated(device) \
        if cuda else None
    out["param_bytes"] = sum(p.numel() * p.element_size()
                             for p in model.parameters())
    if keep:
        out["params"] = {n: p.detach().cpu()
                         for n, p in model.named_parameters()}
    del model, ostate
    free_memory()
    return out


def dp_worker(job: dict) -> int:
    """One rank of ``dp_train_phase`` (``chip_smoke.py --dp-worker JOB``):
    torchrun's ``RANK`` and ``WORLD_SIZE`` from the environment, the
    group joined through the job's store; the float32 step, the bf16
    steps under FSDP, one bf16 step of the whole model on every rank
    (the parent's placement, for its peak memory and step time, and the
    parameters after its step that the FSDP ranks' gathered slices after
    their first step are held to: ``step_gap``), then the dry run's FSDP
    cut (``dryrun.execute_cell(..., data=world)``); writes the results
    to the job's ``out``."""
    import torch.distributed as dist
    from datetime import timedelta
    from repro_torch.launch import dryrun
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if job["device"] == "cuda":
        device = torch.device(f"cuda:{rank}" if job["backend"] == "nccl"
                              else "cuda:0")
        torch.cuda.set_device(device)
    else:
        device = torch.device(job["device"])
    dist.init_process_group(job["backend"], init_method=job["init"],
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=DP_TIMEOUT))
    try:
        mesh = make_local_mesh(device)
        smoke = job["smoke"]
        out = {"device": str(device)}
        out["f32"] = dp_f32_step(device, mesh, smoke)
        out["bf16"] = dp_steps(device, mesh, job["steps"], smoke, keep=False,
                               first=True)
        out["whole"] = dp_steps(device, mesh, 1, smoke, keep=False,
                                whole=True, first=True)
        out["step_one"] = step_gap(out["bf16"].pop("first"),
                                   out["whole"].pop("first"))
        arch, shape, n_layers, batch = DP_DRYRUN
        cut = dryrun.execute_cell(
            arch, shape, device, layers=n_layers, batch=batch, data=world,
            **({"cfg": dp_config(True)[0], "seq": 64} if smoke else {}))
        out["dryrun"] = {k: cut[k] for k in (
            "reduced", "data", "data_rank", "model", "model_rank",
            "count_equal", "count_diff", "collectives", "flops", "bytes",
            "meta_flops", "meta_bytes", "measured_s", "step_s",
            "compute_s", "memory_s", "roofline_share", "kernels")}
        torch.save(out, job["out"].format(rank=rank))
    finally:
        dist.destroy_process_group()
    return 0


def spawn_ranks(tmp: str, world: int, job: dict,
                flag: str = "--dp-worker") -> list:
    """``world`` ranks of ``dp_worker`` (``flag`` "--tp-worker":
    ``tp_worker``) as processes, each under ``DP_TIMEOUT``; any rank's
    failure fails the phase. Returns each rank's results."""
    name = f"{flag[2:4]}{world}"
    job = {**job, "init": f"file://{tmp}/{name}_store",
           "out": f"{tmp}/{name}_" + "{rank}.pt"}
    path = Path(tmp) / f"{name}.json"
    path.write_text(json.dumps(job))
    env = {**os.environ, "WORLD_SIZE": str(world),
           "PYTHONPATH": str(ROOT / "src")}
    procs = [subprocess.Popen(
        [sys.executable, str(ROOT / "chip_smoke.py"), flag,
         str(path)], env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, cwd=ROOT)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            try:
                logs.append(p.communicate(timeout=DP_TIMEOUT))
            except subprocess.TimeoutExpired:
                logs.append(("", "timed out"))
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, (p, (out, err)) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"rank {r} of {world} ({flag}): rc "
              f"{p.returncode}\n{out[-2000:]}\n{err[-6000:]}")
    return [torch.load(job["out"].format(rank=r), weights_only=False)
            for r in range(world)]


def dp_joined(ranks, name: str) -> torch.Tensor:
    """The ranks' float32 gradient slices of ``name`` joined in rank
    order on its sliced dim (the first rank's where it is whole)."""
    d = ranks[0]["f32"]["data_dims"].get(name)
    if d is None:
        return ranks[0]["f32"]["grads"][name]
    return torch.cat([r["f32"]["grads"][name] for r in ranks], dim=d)


def dp_train_phase(device, smoke: bool = False) -> dict:
    """Data-parallel training over ``torch.distributed``, FSDP over "data"
    (each rank holds its slices of every weight with an "embed" dim and
    of AdamW's m and v, gathers a block's weights where it runs and
    reduce-scatters their gradients in a fixed order): ``DP_RANKS`` ranks
    on 2 full-width granite-moe-3b-a800m layers, wq and wk at their true
    fan-in, each with 2 x 1024 tokens of the global 4 x 1024; NCCL over
    that many cards where there are as many, else gloo with every rank on
    the one card (NCCL refuses two ranks on one GPU).
    (a) One float32 step against one process on the global batch under
    ``use_mesh`` with ``data_group_count() == 2``, on the kernel path:
    the loss within 1e-4, every gradient (the ranks' slices joined)
    within ``TRAIN_GRAD_TOL`` of its largest entry, at most
    ``ROUTE_LIMIT`` of the top-8 routes differing (F3's limits).
    (a') Each rank's gradient slices bit for bit the slices of the same
    step's whole gradients summed by ``sum_gradients``.
    (b) ``DP_STEPS`` bf16 AdamW steps: finite losses, the parameters
    gathered in rank order bit for bit equal on every rank after every
    step, the loss, gradient norm and learning rate bit for bit equal on
    every rank; after the first step the gathered parameters against
    those of one step of the whole model on every rank (the replicated
    placement) on the same rows: bit for bit where neither step clips
    (the gradients are ``sum_gradients``' bits), else within one unit in
    the last place (the norm's float32 order differs, and with it the
    clipping scale); each rank's peak memory, the step's ms and the ms
    inside the data axis's collectives, beside that step of the whole
    model's. (c) One rank (this process, a
    group of one) through the distributed path: the plain trainer's
    ``DP_STEPS`` steps bit for bit. Returns the ranks' FSDP dry-run cuts
    (``DP_DRYRUN``) for ``dryrun_phase``."""
    from repro_torch.launch.mesh import Mesh
    cuda = device.type == "cuda"
    cards = torch.cuda.device_count() if cuda else 0
    backend = "nccl" if cards >= DP_RANKS else "gloo"
    job = {"backend": backend, "device": "cuda" if cuda else str(device),
           "steps": DP_STEPS, "smoke": smoke}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_ranks(tmp, DP_RANKS, job)
        t_two = time.perf_counter() - t0
        # (c) in this process: a group of one rank
        import torch.distributed as dist
        from datetime import timedelta
        dist.init_process_group(backend, init_method=f"file://{tmp}/one",
                                rank=0, world_size=1,
                                timeout=timedelta(seconds=DP_TIMEOUT))
        try:
            mine = dp_steps(device, make_local_mesh(device), DP_STEPS, smoke,
                            keep=True)
        finally:
            dist.destroy_process_group()
    t_one = time.perf_counter() - t0 - t_two
    # (a) the ranks' float32 step against one process on the global batch
    # with 2 MoE groups
    global_mesh = Mesh((device,) * DP_RANKS, ("data", "model"),
                       {"data": DP_RANKS, "model": 1})
    want = dp_f32_step(device, global_mesh, smoke)
    got = ranks[0]["f32"]
    check(all(torch.equal(r["f32"]["loss"], got["loss"]) for r in ranks),
          "the ranks' losses differ")
    check(got["data_dims"] and all(r["f32"]["data_dims"] == got["data_dims"]
                                   for r in ranks),
          "the ranks hold no slices, or different ones")
    dloss = abs(float(got["loss"]) - float(want["loss"]))
    errs = {n: _rel_err(dp_joined(ranks, n), g)
            for n, g in want["grads"].items()}
    worst = max(errs, key=errs.get)
    check(len(want["routes"]) == len(got["routes"]), "routing calls differ")
    diff = total = 0
    for i, w in enumerate(want["routes"]):
        g = torch.cat([r["f32"]["routes"][i] for r in ranks])
        diff += int((w.sort(dim=-1).values != g.sort(dim=-1).values)
                    .any(dim=-1).sum())
        total += w.shape[0]
    slices = [r["f32"]["slices_equal"] for r in ranks]
    # (c) one rank against the plain trainer
    plain = dp_steps(device, None, DP_STEPS, smoke, keep=True)
    same_one = (torch.equal(torch.stack(mine["losses"]),
                            torch.stack(plain["losses"])) and
                torch.equal(torch.stack(mine["norms"]),
                            torch.stack(plain["norms"])) and
                all(torch.equal(mine["params"][n], p)
                    for n, p in plain["params"].items()))
    bf16 = [r["bf16"] for r in ranks]
    whole = [r["whole"] for r in ranks]
    scalars = all(torch.equal(torch.stack(b[k]), torch.stack(bf16[0][k]))
                  for b in bf16[1:] for k in ("losses", "norms", "lrs"))
    losses = [float(x) for x in bf16[0]["losses"]]
    gb = [None if b["peak_bytes"] is None else b["peak_bytes"] / 1e9
          for b in bf16]
    gb_whole = [None if w["peak_bytes"] is None else w["peak_bytes"] / 1e9
                for w in whole]
    # (b) after the first step, the FSDP ranks' gathered parameters
    # against the whole model's: the gradients are sum_gradients' bits,
    # so only the norm's float32 order differs, and it moves the update
    # only where the step clips
    clip = opt.AdamWConfig().clip_norm
    norm_one = [float(bf16[0]["norms"][0]), float(whole[0]["norms"][0])]
    clipped = max(norm_one) > clip
    gaps = [r["step_one"] for r in ranks]
    gap = max(gaps, key=lambda g: g["max_ulps"])
    out = {"backend": backend, "devices": [r["device"] for r in ranks],
           "ranks": DP_RANKS, "loss": float(got["loss"]),
           "loss_global": float(want["loss"]), "dloss": dloss,
           "max_rel_grad_err": errs[worst], "worst_grad": worst,
           "routes_compared": total, "routes_differing": diff,
           "slices_bit_for_bit": slices,
           "bf16_losses": losses, "bf16_agree": [b["agree"] for b in bf16],
           "scalars_equal": scalars, "step_one_gap": gaps,
           "step_one_norms": norm_one, "step_one_clipped": clipped,
           "bf16_step_s": bf16[0]["step_s"], "bf16_coll_s": bf16[0]["coll_s"],
           "peak_gb": gb, "param_gb": [b["param_bytes"] / 1e9 for b in bf16],
           "whole_step_s": whole[0]["step_s"],
           "whole_coll_s": whole[0]["coll_s"], "whole_peak_gb": gb_whole,
           "whole_param_gb": [w["param_bytes"] / 1e9 for w in whole],
           "plain_step_s": plain["step_s"], "one_rank_step_s": mine["step_s"],
           "one_rank_bit_for_bit": same_one,
           "wall_two_ranks_s": t_two, "wall_one_rank_s": t_one}

    def ms(xs):
        return " ".join(f"{1e3 * x:.1f}" for x in xs)

    if cuda:
        print(card_line())
    print(f"FSDP over data, {TRAIN_ARCH} (2 of 32 layers at full width, wq "
          f"and wk at their true fan-in), {DP_RANKS} ranks over {backend} on "
          f"{out['devices']}, {TRAIN_BATCH} x {TRAIN_SEQ} tokens split "
          f"{TRAIN_BATCH // DP_RANKS} rows a rank: (a) float32 step: loss "
          f"{out['loss']:.6f} vs one process on the global batch with 2 MoE "
          f"groups {out['loss_global']:.6f}; worst gradient {worst} rel err "
          f"{errs[worst]:.3e} over {len(errs)} tensors; top-k sets differing "
          f"{diff} of {total}; (a') gradient slices bit for bit "
          f"sum_gradients' slices {slices}; (b) bf16 AdamW losses " +
          " ".join(f"{x:.4f}" for x in losses) + f"; gathered parameters "
          f"equal on the ranks after every step {out['bf16_agree']}, loss, "
          f"norm and lr equal {scalars}; after step 1 against the whole "
          f"model's step: {gap['differing']} of {gap['elements']} elements "
          f"differ, largest {gap['max_abs']:.3e} ({gap['max_ulps']:.3g} "
          f"ulp), grad norm {norm_one[0]!r} vs {norm_one[1]!r} (clipped: "
          f"{clipped}); step ms {ms(out['bf16_step_s'])}, "
          f"of which inside the data axis's collectives "
          f"{ms(out['bf16_coll_s'])}; peak memory a rank GB "
          f"{[round(x, 3) for x in gb if x is not None]} (parameters "
          f"{[round(x, 3) for x in out['param_gb']]}); the whole model on "
          f"every rank (the replicated placement): step ms "
          f"{ms(out['whole_step_s'])}, of which the gradient sum and "
          f"collectives {ms(out['whole_coll_s'])}, peak GB "
          f"{[round(x, 3) for x in gb_whole if x is not None]} (parameters "
          f"{[round(x, 3) for x in out['whole_param_gb']]}); one process, "
          f"no collective: step ms {ms(plain['step_s'])}; (c) one rank "
          f"through the distributed path equals the plain trainer's "
          f"{DP_STEPS} steps bit for bit: {same_one} (one-rank step ms "
          f"{ms(mine['step_s'])}); the spawned ranks {t_two:.1f} s, the one "
          f"rank {t_one:.1f} s")
    check(dloss <= 1e-4, f"data-parallel loss differs by {dloss}")
    check(errs[worst] <= TRAIN_GRAD_TOL, f"gradient {worst}: {errs[worst]}")
    check(diff <= ROUTE_LIMIT * total, f"{diff} of {total} routes differ")
    check(all(slices), f"a rank's gradient slices differ from "
          f"sum_gradients' slices: {slices}")
    check(all(map(math.isfinite, losses)), f"losses {losses}")
    check(all(all(b["agree"]) for b in bf16),
          f"the ranks' gathered parameters differ: {out['bf16_agree']}")
    check(scalars, "the ranks' losses, norms or learning rates differ")
    check(all(g["max_ulps"] <= 1 if clipped else g["differing"] == 0
              for g in gaps),
          f"after step 1 the FSDP parameters differ from the whole model's "
          f"(clipped: {clipped}): {gaps}")
    check(same_one, "one rank through the distributed path differs from "
          "the plain trainer")
    out["dryrun"] = [r["dryrun"] for r in ranks]
    free_memory()
    return out


# -- phase 9b: the "model" axis: heads, kv heads, ffn, vocab, experts and
# Mamba's d_inner split over processes, the decode cache split by sequence

TP_RANKS = 2
TP_PARITY = ((LM_ARCH, 2), (MOE_ARCH, 2), (HYBRID_ARCH, 8))  # arch, layers
# float32 parity: rows, prompt tokens, ring rows, decode ticks
TP_ROWS, TP_PROMPT, TP_CACHE, TP_TICKS = 2, 256, 512, 4
TP_STEP = (2, 512)             # granite's float32 step: rows x tokens
# h2o-danube-1.8b whole in bf16: prompts, tokens each, ring rows, ticks
# (32 ticks: 64 took ~16 s of the smoke's time limit)
TP_SERVE = (16, 512, 1024, 32)
# the dry run's model-axis cut: arch, shape, layers, batch
TP_DRYRUN = (LM_ARCH, "decode_32k", 2, 8)


def tp_config(arch: str, smoke: bool, **overrides):
    """``arch`` as ``served_config`` gives it (``smoke``: its smoke
    config, for a rehearsal on the CPU), with ``overrides``."""
    from repro_torch.configs.base import get_smoke_config
    if smoke:
        return get_smoke_config(arch).scaled(**overrides)
    return served_config(arch, **overrides)


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def tp_built(device, cfg, mesh, trainable: bool = False):
    """``cfg``'s model from seed 0 with unit scores (F3): this rank's of
    ``mesh``'s model axis, the ranks building in turn (the others wait
    at a barrier), so that one rank's full-layer draws at a time are on
    the card beside the built halves; the whole with no mesh."""
    def build():
        model = tf.init_model(cfg, torch.Generator(device=device)
                              .manual_seed(0), device, trainable=trainable,
                              mesh=mesh)
        unit_scores(model)
        return model
    if mesh is None:
        return build()
    import torch.distributed as dist
    model = None
    for r in range(mesh.shape["model"]):
        if r == mesh.model_rank:
            model = build()
            free_memory()
        dist.barrier(group=mesh.model_group)
    return model


def tp_parity_run(device, cfg, mesh) -> dict:
    """``cfg`` in float32 with unit scores (F3), this process's model (a
    rank's of ``mesh``'s model axis, or the whole with None): the
    prefill step's last logits of ``TP_ROWS`` prompts of ``TP_PROMPT``
    tokens into rings of ``TP_CACHE`` rows, then ``TP_TICKS`` decode
    steps of seeded tokens; each step's logits and every routing."""
    model = tp_built(device, cfg, mesh)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (TP_ROWS, TP_PROMPT))
    ticks = rng.integers(0, cfg.vocab_size, (TP_TICKS, TP_ROWS, 1))
    prefill = steps.make_prefill_step(cfg, mesh, TP_CACHE)
    decode = steps.make_decode_step(cfg, mesh)
    log, label = [], [("prefill", 0)]
    with recorded_routes(log, label):
        logits, caches = prefill(model, {"tokens": tokens})
        out = [logits.float().cpu()]
        pos = torch.full((TP_ROWS,), TP_PROMPT, dtype=torch.int32)
        for t in ticks:
            logits, caches = decode(model, caches,
                                    {"tokens": t, "pos": pos})
            out.append(logits.float().cpu())
            pos = pos + 1
    del model, caches
    free_memory()
    return {"logits": out, "routes": [r.cpu() for _, r in log]}


def tp_step_run(device, mesh, smoke: bool = False) -> dict:
    """One float32 step of 2 full-width granite-moe-3b-a800m layers (unit
    scores): the loss, every gradient (this rank's shards), the routes,
    which parameters are split."""
    cfg = tp_config(TRAIN_ARCH, smoke, num_layers=2, compute_dtype="float32")
    model = tp_built(device, cfg, mesh, trainable=True)
    rng = np.random.default_rng(1)
    batch = {k: rng.integers(0, cfg.vocab_size, TP_STEP)
             for k in ("tokens", "labels")}
    log, label = [], [("step", 0)]
    with recorded_routes(log, label), steps.deterministic():
        loss, grads = steps.loss_and_grads(model, batch, mesh)
    out = {"loss": loss.cpu(), "grads": {n: g.cpu() for n, g in grads.items()},
           "routes": [r.cpu() for _, r in log], "split": model.split_axes()}
    del model, grads
    free_memory()
    return out


def tp_serve_run(device, mesh, smoke: bool = False) -> dict:
    """h2o-danube-1.8b whole in bf16 (unit scores), this rank's slice:
    one prefill step of ``TP_SERVE``'s prompts into split rings, then
    greedy decode ticks; host seconds of the prefill and of each tick
    (each ending in a synchronise), each tick's host seconds inside the
    model axis's gathers, the greedy tokens, and the kernels' launches
    of the run (counts set to 0 just before it)."""
    import torch.distributed as dist
    n, L, S, T = TP_SERVE
    cfg = tp_config(LM_ARCH, smoke, compute_dtype="bfloat16") if smoke \
        else get_config(LM_ARCH)
    model = tp_built(device, cfg, mesh)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (n, L))
    prefill = steps.make_prefill_step(cfg, mesh, S)
    decode = steps.make_decode_step(cfg, mesh)
    spent, real = [0.0], dist.all_gather

    def timed(*args, **kwargs):
        t = time.perf_counter()
        res = real(*args, **kwargs)
        spent[0] += time.perf_counter() - t
        return res

    for k in (rms.rmsnorm, fa.flash_attention, da.decode_attention,
              gmm.moe_gmm):
        k.launches = 0
    dist.all_gather = timed
    try:
        _sync(device)
        t0 = time.perf_counter()
        logits, caches = prefill(model, {"tokens": tokens})
        _sync(device)
        out = {"prefill_s": time.perf_counter() - t0, "tick_s": [],
               "tick_gather_s": [], "prefill_gather_s": spent[0]}
        pos = torch.full((n,), L, dtype=torch.int32)
        greedy = []
        for _ in range(T):
            nxt = logits[:, -1].argmax(dim=-1, keepdim=True)
            greedy.append(nxt.cpu())
            g0 = spent[0]
            t0 = time.perf_counter()
            logits, caches = decode(model, caches, {"tokens": nxt,
                                                    "pos": pos})
            _sync(device)
            out["tick_s"].append(time.perf_counter() - t0)
            out["tick_gather_s"].append(spent[0] - g0)
            pos = pos + 1
    finally:
        dist.all_gather = real
    out["launches"] = lm_launches()
    out["tokens"] = torch.cat(greedy, dim=1)
    out["finite"] = bool(torch.isfinite(logits).all())
    out["cache_rows"] = caches[0]["k"].shape[1]
    del model, caches
    free_memory()
    return out


def tp_worker(job: dict) -> int:
    """One rank of ``model_axis_phase`` (``chip_smoke.py --tp-worker
    JOB``): a gloo group of ``TP_RANKS`` on the one card, the mesh
    ``make_local_mesh(device, model=TP_RANKS)``; the float32 parity runs,
    granite's step, the bf16 serve and the dry run's model-axis cut
    (``dryrun.execute_cell(..., model=TP_RANKS)``)."""
    import torch.distributed as dist
    from datetime import timedelta
    from repro_torch.launch import dryrun
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = torch.device(job["device"] if job["device"] != "cuda"
                          else "cuda:0")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=job["init"], rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=DP_TIMEOUT))
    try:
        mesh = make_local_mesh(device, model=world)
        out = {"model_rank": mesh.model_rank, "parity": {}}
        smoke = job["smoke"]
        for arch, n_layers in TP_PARITY:
            cfg = tp_config(arch, smoke, num_layers=n_layers,
                            compute_dtype="float32")
            out["parity"][arch] = tp_parity_run(device, cfg, mesh)
        out["step"] = tp_step_run(device, mesh, smoke)
        out["serve"] = tp_serve_run(device, mesh, smoke)
        arch, shape, n_layers, batch = TP_DRYRUN
        cut = dryrun.execute_cell(
            arch, shape, device, layers=n_layers, batch=batch, model=world,
            **({"cfg": tp_config(arch, True), "seq": 64} if smoke else {}))
        out["dryrun"] = {k: cut[k] for k in (
            "reduced", "model", "model_rank", "count_equal", "count_diff",
            "collectives", "flops", "bytes", "meta_flops", "meta_bytes",
            "measured_s", "step_s", "compute_s", "memory_s",
            "roofline_share", "kernels")}
        torch.save(out, job["out"].format(rank=rank))
    finally:
        dist.destroy_process_group()
    return 0


def tp_joined(parts, shape) -> torch.Tensor:
    """The model ranks' shards of a parameter joined in rank order on the
    dim that differs from the one-process ``shape``, cut to it (the
    padded heads and experts, at the end, dropped)."""
    if tuple(parts[0].shape) == tuple(shape):
        return parts[0]
    dim = next(i for i, (a, b) in enumerate(zip(parts[0].shape, shape))
               if a != b)
    return torch.cat(parts, dim=dim).narrow(dim, 0, shape[dim])


def model_axis_phase(device, smoke: bool = False) -> dict:
    """The "model" axis over ``TP_RANKS`` gloo ranks on the one card
    (``tp_worker``), against one process (this one, after the ranks
    ended):
    (a) float32 at full width, unit scores: h2o-danube-1.8b (2 layers,
    the kv heads split), granite-moe-3b-a800m (2 layers, its 24 heads
    padded to 32, kv heads and vocab whole) and one jamba-v0.1-52b period
    (Mamba's d_inner split): the prefill's and each decode tick's logits
    over caches split by sequence within ``LOGIT_TOL`` where no route
    differs, at most ``ROUTE_LIMIT`` of the routes differing, the ranks'
    logits bit for bit equal;
    (b) granite's float32 step: the loss within 1e-4, every gradient
    within ``TRAIN_GRAD_TOL`` of its largest entry (the shards joined),
    every replicated gradient bit for bit equal on both ranks;
    (c) h2o-danube-1.8b whole in bf16: ``TP_SERVE``'s prompts prefilled
    and decoded greedily, the ranks' tokens equal, the prefill's and each
    tick's host ms and each tick's ms inside the gathers, the kernels
    each launched;
    (d) the dry run's cut ``TP_DRYRUN`` executed on both ranks, each
    count (collectives included) equal to the meta count of one device
    of the axis; returned for ``dryrun_phase``.
    ``smoke``: the smoke configs, for a rehearsal on the CPU."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_ranks(tmp, TP_RANKS, {"device": str(device.type),
                                            "smoke": smoke},
                            flag="--tp-worker")
    t_ranks = time.perf_counter() - t0
    out = {"ranks": TP_RANKS, "wall_ranks_s": t_ranks, "parity": {}}
    for arch, n_layers in TP_PARITY:
        cfg = tp_config(arch, smoke, num_layers=n_layers,
                        compute_dtype="float32")
        want = tp_parity_run(device, cfg, None)
        got = [r["parity"][arch] for r in ranks]
        check(all(torch.equal(a, b) for r in got[1:]
                  for a, b in zip(got[0]["logits"], r["logits"])),
              f"model axis {arch}: the ranks' logits differ")
        diff = total = 0
        for w, g in zip(want["routes"], got[0]["routes"]):
            bad = (w.sort(dim=-1).values != g.sort(dim=-1).values).any(-1)
            diff += int(bad.sum())
            total += w.shape[0]
        dl = [float((a - b).abs().max()) for a, b in
              zip(got[0]["logits"], want["logits"])]
        out["parity"][arch] = {"layers": n_layers, "max_abs_dlogit": dl,
                               "routes_compared": total,
                               "routes_differing": diff}
        print(f"model axis {arch} ({n_layers} layers at full width, "
              f"float32, unit scores), {TP_RANKS} ranks against one "
              f"process: max|dlogit| prefill then {TP_TICKS} ticks " +
              " ".join(f"{x:.3e}" for x in dl) + (
                  f"; top-k sets differing {diff} of {total}"
                  if total else ""))
        check(diff <= ROUTE_LIMIT * max(total, 1),
              f"model axis {arch}: {diff} of {total} routes differ")
        if diff == 0:
            check(max(dl) <= LOGIT_TOL, f"model axis {arch}: logits "
                  f"differ by {max(dl)}")
        free_memory()
    want = tp_step_run(device, None, smoke)
    got = [r["step"] for r in ranks]
    check(all(torch.equal(got[0]["loss"], g["loss"]) for g in got[1:]),
          "model axis step: the ranks' losses differ")
    dloss = abs(float(got[0]["loss"]) - float(want["loss"]))
    errs, same = {}, True
    for name, g in want["grads"].items():
        parts = [r["grads"][name] for r in got]
        if "model" not in got[0]["split"][name]:
            same &= all(torch.equal(parts[0], q) for q in parts[1:])
        errs[name] = _rel_err(tp_joined(parts, g.shape), g)
    worst = max(errs, key=errs.get)
    diff = sum(int((w.sort(dim=-1).values != g.sort(dim=-1).values)
                   .any(-1).sum())
               for w, g in zip(want["routes"], got[0]["routes"]))
    total = sum(w.shape[0] for w in want["routes"])
    out["step"] = {"loss": float(got[0]["loss"]),
                   "loss_one_process": float(want["loss"]), "dloss": dloss,
                   "max_rel_grad_err": errs[worst], "worst_grad": worst,
                   "replicated_grads_equal": same,
                   "routes_compared": total, "routes_differing": diff}
    print(f"model axis {TRAIN_ARCH} float32 step (2 layers, {TP_STEP[0]} x "
          f"{TP_STEP[1]} tokens): loss {out['step']['loss']:.6f} vs one "
          f"process {out['step']['loss_one_process']:.6f}; worst gradient "
          f"{worst} rel err {errs[worst]:.3e}; replicated gradients equal "
          f"on both ranks {same}; top-k sets differing {diff} of {total}")
    check(dloss <= 1e-4, f"model axis step: the loss differs by {dloss}")
    check(errs[worst] <= TRAIN_GRAD_TOL, f"model axis gradient {worst}: "
          f"{errs[worst]}")
    check(same, "model axis step: a replicated gradient differs between "
          "the ranks")
    check(diff <= ROUTE_LIMIT * total, f"model axis step: {diff} of "
          f"{total} routes differ")
    serve = [r["serve"] for r in ranks]
    s0 = serve[0]
    n, L, S, T = TP_SERVE
    check(all(torch.equal(s0["tokens"], s["tokens"]) for s in serve[1:]),
          "model axis serve: the ranks' greedy tokens differ")
    check(all(s["finite"] for s in serve), "model axis serve: logits not "
          "finite")
    for k in ("rmsnorm", "flash_attention", "decode_attention"):
        check(s0["launches"][k] > 0, f"model axis serve: {k} not launched")
    out["serve"] = {k: s0[k] for k in ("prefill_s", "tick_s",
                                       "tick_gather_s", "prefill_gather_s",
                                       "launches", "cache_rows")}
    ticks = np.array(s0["tick_s"][1:]) * 1e3
    gathers = np.array(s0["tick_gather_s"][1:]) * 1e3
    if device.type == "cuda":
        print(card_line())
    print(f"model axis serve {LM_ARCH} whole, bf16, {TP_RANKS} gloo ranks on "
          f"one card: {n} prompts of {L} tokens prefilled in "
          f"{s0['prefill_s'] * 1e3:.1f} ms (gathers "
          f"{s0['prefill_gather_s'] * 1e3:.1f} ms of it), rings of {S} rows "
          f"({s0['cache_rows']} a rank); {T} greedy ticks: median "
          f"{np.median(ticks):.2f} ms a tick (min {ticks.min():.2f}, max "
          f"{ticks.max():.2f}; the first {s0['tick_s'][0] * 1e3:.2f}), of "
          f"which the model axis's gathers median {np.median(gathers):.2f} "
          f"ms (host); kernels {s0['launches']}")
    out["dryrun"] = [r["dryrun"] for r in ranks]
    out["wall_s"] = time.perf_counter() - t0
    print("model axis: " + json.dumps({k: v for k, v in out.items()
                                       if k != "dryrun"}))
    free_memory()
    return out


# -- phase 9c: a batch of 1 over ("data", "model"): the attention caches'
# sequence spread over every rank, as the JAX placement spreads long_500k

CX_ARCH = "gemma3-12b"
CX_DATA, CX_MODEL = 2, 2
# float32 parity: the prompt's tokens, the global ring's rows (long_500k's
# context), decode ticks, rows of a refill block (a rank's window rows)
CX_PROMPT, CX_RING, CX_TICKS, CX_BLOCK = 4096, 524_288, 4, 256
CX_SMOKE = (48, 64)            # the prompt and ring of a CPU rehearsal
# the dry run's long-context cut: arch, shape, layers (one period), batch
CX_DRYRUN = (CX_ARCH, "long_500k", 6, 1)
# decode attention's slices at gemma3-12b's heads, B = 1: (first row,
# rows, ring, type, position). Data 2 x model 2 holds a quarter of each
# ring: the global ring's 131,072 rows (bf16 in the dry-run cut, float32
# in the parity run) and a window's 256; a pod's 256 ranks hold 4 rows of
# a window. A position inside a slice exercises its row mask.
CX_SLICES = ((131_072, 131_072, 524_288, torch.bfloat16, 231_072),
             (131_072, 131_072, 524_288, torch.float32, 524_291),
             (256, 256, 1024, torch.bfloat16, 1027),
             (4, 4, 1024, torch.bfloat16, 6))


def cx_slice_label(sl) -> str:
    """The label of a ``CX_SLICES`` slice's row at gemma3-12b's heads."""
    r0, S_l, S, dt, p = sl
    cfg = get_config(CX_ARCH)
    return (f"B=1 rows {r0}..{r0 + S_l - 1} of S={S} {cfg.num_heads}/"
            f"{cfg.num_kv_heads}x{cfg.resolved_head_dim} pos {p} "
            f"{str(dt)[6:]}")


def cx_config(smoke: bool, **overrides):
    """gemma3-12b cut to one period (5 window layers, 1 global) at full
    width (``smoke``: its smoke config)."""
    return tp_config(CX_ARCH, smoke, num_layers=6, **overrides)


def cx_refill(caches, n: int, i: int, device) -> None:
    """Every attention ring's rows drawn anew: the ring of layer l in
    blocks of ``CX_BLOCK`` rows (fewer where a rank of the 4 holds fewer),
    block b's k then v from a generator on ``device`` seeded
    l·2^20 + b. Rank i of a cache axis of n draws its own blocks, one
    process (n = 1) every block: the same rows either way."""
    for l, c in enumerate(caches):
        if "k" not in c:
            continue
        rows = c["k"].shape[1]
        blk = min(CX_BLOCK, rows * n // (CX_DATA * CX_MODEL))
        for j in range(rows // blk):
            g = torch.Generator(device=device).manual_seed(
                (l << 20) + i * rows // blk + j)
            for name in ("k", "v"):
                part = c[name][:, j * blk:(j + 1) * blk]
                part.copy_(torch.randn(part.shape, generator=g,
                                       device=device))


def cx_parity_run(device, mesh, smoke: bool = False) -> dict:
    """gemma3-12b's period in float32 with unit scores (F3), this
    process's model (a rank's of ``mesh``, or the whole with None), at a
    batch of 1: the prefill step's last logits of a ``CX_PROMPT``-token
    prompt into rings of ``CX_RING`` rows (only rank 0's rows of the
    global ring hold positions then), every ring row refilled
    (``cx_refill``), then ``CX_TICKS`` decode steps of seeded tokens
    from the ring's last row, wrapping to its first; each step's logits,
    the kernels' launches (counts set to 0 just before the prefill), the
    cache rows and bytes, the prefill's and each tick's host seconds
    (each ending in a synchronise) and the seconds inside the gathers."""
    L, S = CX_SMOKE if smoke else (CX_PROMPT, CX_RING)
    cfg = cx_config(smoke, compute_dtype="float32")
    model = tp_built(device, cfg, mesh)
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, cfg.vocab_size, (1, L))
    ticks = rng.integers(0, cfg.vocab_size, (CX_TICKS, 1, 1))
    prefill = steps.make_prefill_step(cfg, mesh, S)
    decode = steps.make_decode_step(cfg, mesh)
    for k in (rms.rmsnorm, fa.flash_attention, da.decode_attention,
              gmm.moe_gmm):
        k.launches = 0
    with timed_collectives(lambda: _sync(device)) as spent:
        _sync(device)
        t0 = time.perf_counter()
        logits, caches = prefill(model, {"tokens": tokens})
        _sync(device)
        out = {"prefill_s": time.perf_counter() - t0,
               "prefill_gather_s": sum(spent), "tick_s": [],
               "tick_gather_s": [], "logits": [logits.float().cpu()]}
        n, i = pops.serve_placement(mesh, 1)[1]
        cx_refill(caches, n, i, device)
        _sync(device)
        pos = torch.full((1,), S - 1, dtype=torch.int32)
        for t in ticks:
            spent.clear()
            t0 = time.perf_counter()
            logits, caches = decode(model, caches, {"tokens": t,
                                                    "pos": pos})
            _sync(device)
            out["tick_s"].append(time.perf_counter() - t0)
            out["tick_gather_s"].append(sum(spent))
            out["logits"].append(logits.float().cpu())
            pos = pos + 1
    out["launches"] = lm_launches()
    out["finite"] = all(bool(torch.isfinite(x).all()) for x in out["logits"])
    out["cache_rows"] = [c["k"].shape[1] for c in caches if "k" in c]
    out["cache_bytes"] = sum(t.numel() * t.element_size()
                             for c in caches for t in c.values())
    del model, caches
    free_memory()
    return out


def cx_worker(job: dict) -> int:
    """One rank of ``context_phase`` (``chip_smoke.py --cx-worker JOB``):
    a gloo group of ``CX_DATA`` x ``CX_MODEL`` ranks on the one card, the
    mesh ``make_local_mesh(device, model=CX_MODEL)``; the float32 parity
    run, then the dry run's long-context cut in bf16
    (``dryrun.execute_cell(..., model=CX_MODEL, data=CX_DATA)``, its
    ``ITERS`` ticks after ``WARMUP`` timed as every executed cell's) with
    the seconds inside the gathers of those ticks, and the bf16 cache
    bytes of a rank."""
    import torch.distributed as dist
    from datetime import timedelta
    from repro_torch.launch import dryrun
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    device = torch.device(job["device"] if job["device"] != "cuda"
                          else "cuda:0")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group("gloo", init_method=job["init"], rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=DP_TIMEOUT))
    try:
        mesh = make_local_mesh(device, model=CX_MODEL)
        smoke = job["smoke"]
        out = {"coords": (mesh.rank, mesh.model_rank),
               "f32": cx_parity_run(device, mesh, smoke)}
        arch, shape, n_layers, batch = CX_DRYRUN
        spent = []
        cut = dryrun.execute_cell(
            arch, shape, device, layers=n_layers, batch=batch,
            model=CX_MODEL, data=CX_DATA,
            around=timed_collectives(lambda: _sync(device), spent),
            **({"cfg": cx_config(True), "seq": CX_SMOKE[1]}
               if smoke else {}))
        cfg = cx_config(True) if smoke else get_config(arch).scaled(
            num_layers=n_layers)
        seq = CX_SMOKE[1] if smoke else CX_RING
        out["bf16"] = {
            "gather_s_a_tick": sum(spent) / (dryrun.WARMUP + dryrun.ITERS),
            "cache_bytes": dryrun._nbytes(tf.init_caches(
                cfg, 1, seq, "meta", mesh=mesh)),
            "cache_bytes_one_process": dryrun._nbytes(tf.init_caches(
                cfg, 1, seq, "meta")),
            "cut": {k: cut[k] for k in (
                "reduced", "data", "data_rank", "model", "model_rank",
                "count_equal", "count_diff", "collectives", "flops",
                "bytes", "meta_flops", "meta_bytes", "measured_s",
                "step_s", "compute_s", "memory_s", "roofline_share",
                "kernels")}}
        torch.save(out, job["out"].format(rank=rank))
    finally:
        dist.destroy_process_group()
    return 0


def context_phase(device, smoke: bool = False) -> dict:
    """A batch of 1 over ("data", "model"): ``CX_DATA`` x ``CX_MODEL`` gloo
    ranks on the one card (``cx_worker``), each holding a quarter of every
    attention ring, data major, against one process (this one, after the
    ranks ended):
    (a) gemma3-12b's period at full width in float32, unit scores: the
    prefill's and each tick's logits within ``LOGIT_TOL`` of one
    process's, the 4 ranks' logits bit for bit equal, every rank holding
    a quarter of each ring's rows, the kernels each launched on every
    rank;
    (b) the dry run's cut ``CX_DRYRUN`` in bf16 on every rank, its count
    (collectives included) equal to the meta count of one device of the
    mesh (returned for ``dryrun_phase``); its ms a tick, the ms inside
    the gathers and a rank's cache bytes, beside one process's.
    ``smoke``: the smoke config, for a rehearsal on the CPU."""
    t0 = time.perf_counter()
    world = CX_DATA * CX_MODEL
    with tempfile.TemporaryDirectory() as tmp:
        ranks = spawn_ranks(tmp, world, {"device": str(device.type),
                                         "smoke": smoke},
                            flag="--cx-worker")
    t_ranks = time.perf_counter() - t0
    check([r["coords"] for r in ranks] ==
          [(d, c) for d in range(CX_DATA) for c in range(CX_MODEL)],
          f"context: the ranks' coordinates {[r['coords'] for r in ranks]}")
    want = cx_parity_run(device, None, smoke)
    got = [r["f32"] for r in ranks]
    g0 = got[0]
    same = all(torch.equal(a, b) for g in got[1:]
               for a, b in zip(g0["logits"], g["logits"]))
    dl = [float((a - b).abs().max()) for a, b in
          zip(g0["logits"], want["logits"])]
    L, S = CX_SMOKE if smoke else (CX_PROMPT, CX_RING)
    rows = sorted(set(g0["cache_rows"]))
    if device.type == "cuda":
        print(card_line())
    print(f"context {CX_ARCH} (one period at full width, float32, unit "
          f"scores, batch 1): {CX_DATA} x {CX_MODEL} gloo ranks against one "
          f"process: a {L}-token prompt into a ring of {S} rows, refilled, "
          f"then {CX_TICKS} ticks from row {S - 1}: max|dlogit| prefill then "
          "ticks " + " ".join(f"{x:.3e}" for x in dl) +
          f"; the ranks' logits equal {same}; ring rows a rank {rows} "
          f"(one process {sorted(set(want['cache_rows']))}); kernels "
          f"{g0['launches']}")
    check(same, "context: the ranks' logits differ")
    check(all(g["finite"] for g in got) and want["finite"],
          "context: logits not finite")
    check(max(dl) <= LOGIT_TOL, f"context: logits differ by {max(dl)}")
    rings = [min(S, spec.window or S) for spec in cx_config(smoke).pattern]
    check(all(g["cache_rows"] == [r // world for r in rings] for g in got),
          f"context: a rank's ring rows {g0['cache_rows']}, not a quarter "
          f"of {rings}")
    for g in got:
        for k in ("rmsnorm", "flash_attention", "decode_attention"):
            check(g["launches"][k] > 0, f"context: {k} not launched")
    ticks = np.array(g0["tick_s"]) * 1e3
    gathers = np.array(g0["tick_gather_s"]) * 1e3
    bf = [r["bf16"] for r in ranks]
    cut = [b["cut"] for b in bf]
    one = bf[0]["cache_bytes_one_process"]
    print(f"context float32 on rank 0: prefill {g0['prefill_s'] * 1e3:.1f} ms "
          f"(gathers {g0['prefill_gather_s'] * 1e3:.1f} ms of it); ticks "
          + " ".join(f"{t:.1f}" for t in ticks) + " ms, of which the "
          "gathers (host) " + " ".join(f"{t:.1f}" for t in gathers) +
          f" ms; cache bytes a rank {g0['cache_bytes'] / 1e9:.4f} GB, one "
          f"process {want['cache_bytes'] / 1e9:.4f} GB")
    print(f"context bf16 cut {cut[0]['reduced']}: cache bytes a rank "
          f"{bf[0]['cache_bytes'] / 1e9:.4f} GB (the sequence over \"model\" "
          f"only {one / CX_MODEL / 1e9:.4f} GB, one process "
          f"{one / 1e9:.4f} GB); median "
          f"{cut[0]['measured_s'] * 1e3:.2f} ms a tick of "
          f"{[round(t * 1e3, 2) for t in cut[0]['step_s']]}, of which the "
          f"gathers (host) {bf[0]['gather_s_a_tick'] * 1e3:.2f} ms a tick; "
          f"counts equal to meta's on the ranks "
          f"{[c['count_equal'] for c in cut]}")
    check(all(b["cache_bytes"] * world == one for b in bf),
          f"context: a rank's cache bytes {bf[0]['cache_bytes']} are not a "
          f"quarter of one process's {one}")
    out = {"ranks": world, "wall_ranks_s": t_ranks,
           "max_abs_dlogit": dl, "ranks_equal": same,
           "launches": g0["launches"], "cache_rows": g0["cache_rows"],
           "f32_cache_bytes": g0["cache_bytes"],
           "f32_prefill_s": g0["prefill_s"], "f32_tick_s": g0["tick_s"],
           "f32_tick_gather_s": g0["tick_gather_s"],
           "bf16_cache_bytes": bf[0]["cache_bytes"],
           "bf16_cache_bytes_one_process": one,
           "bf16_tick_s": cut[0]["step_s"],
           "bf16_gather_s_a_tick": bf[0]["gather_s_a_tick"],
           "dryrun": cut, "wall_s": time.perf_counter() - t0}
    print("context: " + json.dumps({k: v for k, v in out.items()
                                    if k != "dryrun"}))
    free_memory()
    return out


# -- phase 10: the dry run: counted on meta, checked on the card ------------

# (arch, shape, layers, batch): the cells the card executes, cut to fit
DRYRUN_EXECUTED = (("h2o-danube-1.8b", "prefill_32k", None, 1),
                   ("h2o-danube-1.8b", "decode_32k", None, 8),
                   ("granite-moe-3b-a800m", "train_4k", 2, 4))
# one meta cell of each kind on each mesh the port executes (the whole
# grid runs through ``python -m repro_torch.launch.dryrun --mesh all``;
# xlstm-125m's 32k prefill and 4k training step alone take minutes, one
# eager sLSTM step a token)
DRYRUN_KINDS = (("granite-moe-3b-a800m", "train_4k"),
                ("h2o-danube-1.8b", "prefill_32k"),
                ("h2o-danube-1.8b", "decode_32k"),
                ("jamba-v0.1-52b", "long_500k"))


def dryrun_phase(device, model_axis=(), data_axis=()) -> dict:
    """The dry run (``repro_torch.launch.dryrun``): one cell of each kind
    counted on ``meta`` on the ``card``, ``node`` and ``pod`` meshes (the
    pod's one device of the 16-way model axis) and one on ``multipod``,
    and the JAX placement's bytes of every cell on ``pod`` and
    ``multipod``, each with its wall time; then the three executed cells
    (``execute_cell``) on the card, each of whose counted FLOPs, bytes
    and kernel and op calls must equal the ``meta`` count at the same
    cut, and whose roofline share (max(compute_s, memory_s) over the
    measured median step) must not exceed 1: a share above 1 is a count
    that is too large. ``model_axis``: each rank's result of the
    model-axis cut (``model_axis_phase``), and ``data_axis``: of the FSDP
    cut over 2 data ranks (``dp_train_phase``), whose counts,
    collectives included, must equal their ``meta`` counts too."""
    from repro_torch.launch import dryrun
    t0 = time.perf_counter()
    grid = {}
    kinds = [(a, s, m) for a, s in DRYRUN_KINDS
             for m in ("card", "node", "pod")] + [DRYRUN_KINDS[0] +
                                                  ("multipod",)]
    for arch, shape, mesh in kinds:
        r = dryrun.run_cell(arch, shape, mesh)
        rf = r["roofline"]
        grid[f"{arch}__{shape}__{mesh}"] = r["timing"]["count_s"]
        jax_mem = (f" (the JAX placement "
                   f"{r['jax_memory']['total_bytes'] / 1e9:.2f} GB)"
                   if "jax_memory" in r else "")
        print(f"dryrun {arch} {shape} {mesh}: {r['per_device']['flops']:.4e}"
              f" FLOPs, {r['per_device']['bytes']:.4e} bytes, "
              f"collectives {r['per_device']['collective_bytes']:.4e} B a "
              f"device; compute {rf['compute_s']:.4f} s, memory "
              f"{rf['memory_s']:.4f} s, collective "
              f"{rf['collective_s']:.4f} s ({rf['dominant']}); useful "
              f"{rf['useful_flops_ratio']:.3f}; memory "
              f"{r['memory']['total_bytes'] / 1e9:.2f} GB fits "
              f"{r['memory']['fits']}{jax_mem}; counted in "
              f"{r['timing']['count_s']:.2f} s")
        check(r["per_device"]["flops"] > 0, f"dryrun {arch} {shape} {mesh}:"
              " nothing counted")
    n_placed = 0
    t_placed = time.perf_counter()
    for arch in dryrun.cfgbase.ARCH_IDS:
        cfg = dryrun.cfgbase.get_config(arch)
        for cell in dryrun.cfgbase.cells_for(arch):
            for mesh in ("pod", "multipod"):
                r = dryrun.jax_placement(cfg, cell, mesh)
                check(r["memory"]["total_bytes"] > 0,
                      f"dryrun {arch} {cell.name} {mesh}: no placement")
                n_placed += 1
    print(f"dryrun JAX placements: {n_placed} pod and multipod cells in "
          f"{time.perf_counter() - t_placed:.2f} s")
    for r in list(model_axis) + list(data_axis):
        print(f"dryrun executed {r['reduced']} on model rank "
              f"{r['model_rank']} of {r['model']}, data rank "
              f"{r.get('data_rank', 0)} of {r.get('data', 1)} (gloo ranks on "
              f"one card): "
              f"count equal {r['count_equal']} ({r['flops']} FLOPs, "
              f"{r['bytes']} bytes, collectives {r['collectives']}; meta "
              f"{r['meta_flops']}, {r['meta_bytes']}); median "
              f"{r['measured_s'] * 1e3:.3f} ms of "
              f"{[round(t * 1e3, 3) for t in r['step_s']]}; roofline share "
              f"{r['roofline_share']:.4f}; kernels "
              f"{ {k: v['calls'] for k, v in r['kernels'].items()} }")
        check(r["count_equal"], f"dryrun cut {r['reduced']}, model rank "
              f"{r['model_rank']}, data rank {r.get('data_rank', 0)}: the "
              f"count differs from meta's: {r['count_diff']}")
    executed = {}
    for arch, shape, n_layers, batch in DRYRUN_EXECUTED:
        r = dryrun.execute_cell(arch, shape, device, layers=n_layers,
                                batch=batch)
        executed[f"{arch}__{shape}"] = r
        print(f"dryrun executed {arch} {shape} (cut {r['reduced']}): count "
              f"equal {r['count_equal']} ({r['flops']} FLOPs, {r['bytes']} "
              f"bytes on the card; {r['meta_flops']}, {r['meta_bytes']} on "
              f"meta); median {r['measured_s'] * 1e3:.3f} ms of "
              f"{[round(t * 1e3, 3) for t in r['step_s']]}; compute "
              f"{r['compute_s'] * 1e3:.3f} ms, memory "
              f"{r['memory_s'] * 1e3:.3f} ms; roofline share "
              f"{r['roofline_share']:.4f}; mfu {r['mfu']:.4f}; kernels "
              f"{ {k: v['calls'] for k, v in r['kernels'].items()} }")
        check(r["count_equal"], f"dryrun {arch} {shape}: the card's count "
              f"differs from the meta count at the same cut: "
              f"{r['count_diff']} (the card's, meta's)")
        check(0 < r["roofline_share"] <= 1.0,
              f"dryrun {arch} {shape}: roofline share "
              f"{r['roofline_share']} > 1: the count is too large")
        free_memory()
    out = {"grid_count_s": grid, "placements": n_placed,
           "model_axis_count_equal": [r["count_equal"] for r in model_axis],
           "data_axis_count_equal": [r["count_equal"] for r in data_axis],
           "executed": {k: {f: v[f] for f in (
               "reduced", "count_equal", "flops", "bytes", "measured_s",
               "compute_s", "memory_s", "roofline_share", "mfu")}
               for k, v in executed.items()},
           "wall_s": time.perf_counter() - t0}
    print("dryrun: " + json.dumps(out))
    return out


BWD_LINES = (   # (name, source, the forward it differentiates, label)
    ("rmsnorm_bwd", "rmsnorm.cu", "src/repro/kernels/rmsnorm.py:38",
     "4096x1536 bfloat16"),
    ("flash_attention_bwd", "flash_attention_bwd.cu",
     "src/repro/kernels/flash_attention.py:118",
     "B=4 S=1024 24/8x64 bfloat16"),
    ("moe_gmm_bwd", "moe_gmm.cu", "src/repro/kernels/moe_gmm.py:50",
     "C=1024 1536->512 bfloat16"))


def bwd_line(name, source, forward, label, rows, launches) -> dict:
    """A backward kernel's entry of the ``kernels`` line, as ``lm_line``:
    its row at ``label`` (granite's training shape, bf16), the largest
    error over its rows, its launches in the training phase. It replaces
    no Pallas kernel: the JAX package has no backward kernel and trains
    through XLA's derivative of the forward's function."""
    mine = {lab: r for (n, lab), r in rows.items() if n == name}
    row = next(r for lab, r in mine.items() if lab.endswith(label))
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": f"none (XLA's derivative of the function of "
                        f"{forward})", "launches": launches,
            "max_abs_err": max(r["max_abs_err"] for r in mine.values()),
            **{k: row[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                   "library_ms")}}


LM_REPLACES = {"rmsnorm": "src/repro/kernels/rmsnorm.py:38",
               "flash_attention": "src/repro/kernels/flash_attention.py:118",
               "decode_attention": "src/repro/kernels/decode_attention.py:71",
               "decode_attention_slice":
               "src/repro/kernels/decode_attention.py:71",
               "moe_gmm": "src/repro/kernels/moe_gmm.py:50"}


def context_entry(rows, launches: dict) -> dict:
    """The ``kernels`` line's entry of the context phase: decode
    attention's launches in its float32 run (rank 0's, every slice of
    every ring), once, and the ``CX_SLICES`` rows, each marked whether
    the phase's data 2 x model 2 ranks launch that slice."""
    shapes = []
    for sl in CX_SLICES:
        row = rows[("decode_attention_slice", cx_slice_label(sl))]
        shapes.append({
            "shape": f"{cx_slice_label(sl)} (a rank's slice of a "
                     f"{CX_ARCH} long_500k ring)",
            "launched_here": sl[1] * CX_DATA * CX_MODEL == sl[2],
            **{k: row[k] for k in ("max_abs_err", "ms", "plain_ms",
                                   "bound_ms", "bound_by", "library_ms")}})
    return {"launches": launches["decode_attention"], "shapes": shapes}


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
    if len(sys.argv) == 3 and sys.argv[1] == "--dp-worker":
        return dp_worker(json.loads(Path(sys.argv[2]).read_text()))
    if len(sys.argv) == 3 and sys.argv[1] == "--tp-worker":
        return tp_worker(json.loads(Path(sys.argv[2]).read_text()))
    if len(sys.argv) == 3 and sys.argv[1] == "--cx-worker":
        return cx_worker(json.loads(Path(sys.argv[2]).read_text()))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the card only",
              file=sys.stderr)
        return 1
    device = torch.device("cuda")
    t_start = time.perf_counter()

    def mark(what: str) -> None:
        """The script's wall so far, after ``what`` (for cutting it to
        its time limit)."""
        print(f"chip_smoke: {what} done at "
              f"{time.perf_counter() - t_start:.1f} s", flush=True)

    print(card_line())
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    build_phase()
    mark("build")
    # a training step's bits, before every other phase (compared with the
    # same step after them, below)
    early_bits = step_bits_phase(device)
    rows = kernel_phase(device)
    head_row = head_phase(device)
    grouped = grouped_kernel_phase(device)
    operator_phase(device)
    mark("query kernels")
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
    mark("query")
    # the multi-query main path: 8 queries over 3 cameras, standalone and
    # through the FleetScheduler (untraced, traced)
    fleet = fleet_phase(device)
    print("fleet: " + json.dumps(fleet))
    print("mesh probe: " + json.dumps(mesh_probe_phase(device)))
    mark("fleet")
    # the LM zoo's path: its kernels at the served shapes, the whole
    # model against its plain path, then the model served, untraced and
    # once more under the profiler; h2o-danube-1.8b, then
    # granite-moe-3b-a800m (each phase frees its model before the next)
    lm_rows = lm_kernel_phase(device)
    # decode attention over a slice of each ring, with its log-sum-exp
    # (the model axis's tick)
    lm_rows.update(decode_slice_phase(device))
    lm_parity_phase(device)
    serve = serve_lm(device, LM_ARCH)
    lm_rows.update(moe_kernel_phase(device))
    lm_rows.update(lm_kernel_phase(device, MOE_ARCH, MOE_RMS_SHAPES,
                                   MOE_FLASH_SHAPES))
    parity_phase(device)
    moe_serve = serve_lm(device, MOE_ARCH)
    mark("h2o and granite")
    # the recurrent models: jamba-v0.1-52b (one period at full width: 7
    # Mamba layers, 1 attention, 4 MoE) and xlstm-125m (mLSTM and sLSTM,
    # whole): their kernel shapes, float32 parity, the bf16 serve
    lm_rows.update(moe_kernel_phase(device, HYBRID_ARCH, HYBRID_GMM_CAPS,
                                    HYBRID_GMM_DIMS))
    lm_rows.update(lm_kernel_phase(device, HYBRID_ARCH, HYBRID_RMS_SHAPES,
                                   HYBRID_FLASH_SHAPES))
    lm_rows.update(lm_kernel_phase(device, XLSTM_ARCH, XLSTM_RMS_SHAPES, (),
                                   decode=False))
    parity_phase(device, HYBRID_ARCH, dtypes=("float32",))
    hybrid_serve = serve_lm(device, HYBRID_ARCH)
    parity_phase(device, XLSTM_ARCH)
    serve_lm(device, XLSTM_ARCH)
    scan_phase(device)
    mark("jamba and xlstm")
    # the frontends' prefills with their prefix embeddings: llava-next-34b
    # (1024 image patches), musicgen-large (500 audio frames) after its
    # kernels at its shapes
    prefix_phase(device)
    lm_rows.update(lm_kernel_phase(device, MUSIC_ARCH, MUSIC_RMS_SHAPES,
                                   MUSIC_FLASH_SHAPES))
    prefix_phase(device, MUSIC_ARCH)
    # the other accepted configs' head shapes and norm width
    lm_rows.update(lm_kernel_phase(device, WIDE_HEAD_ARCH, (),
                                   WIDE_FLASH_SHAPES, decode=False))
    for arch in GROUP_ARCHS:
        lm_rows.update(lm_kernel_phase(
            device, arch, WIDE_RMS_SHAPES if arch == WIDE_RMS_ARCH else (),
            ()))
    # training: the backward kernels at granite-moe-3b-a800m's training
    # shapes, the step bits against the first phase's, the learning check
    # (2 full-width layers, 30 steps), one float32 step of 2 full-width
    # layers on the kernel path against the plain path, the published
    # config for TRAIN_STEPS steps through launch.train (the last traced),
    # and xlstm-125m's resume
    mark("prefixes and head shapes")
    bwd_rows = bwd_kernel_phase(device)
    same_step_bits(early_bits, step_bits_phase(device))
    del early_bits
    learn_phase(device)
    train_parity_phase(device)
    training = train_phase(device)
    resume_phase(device)
    mark("training")
    # data-parallel training, FSDP over "data": 2 ranks against one
    # process on the global batch, the gradient slices sum_gradients'
    # bits, the ranks' gathered bits equal, one rank the plain trainer's
    dp = dp_train_phase(device)
    print("data parallel: " + json.dumps({k: v for k, v in dp.items()
                                          if k != "dryrun"}))
    mark("FSDP")
    # the model axis: 2 gloo ranks on the card against one process
    # (float32 parity, granite's step), h2o whole in bf16, and the dry
    # run's model-axis cut
    axis = model_axis_phase(device)
    mark("model axis")
    # a batch of 1 over data 2 x model 2: gemma3-12b's period with each
    # ring's sequence spread over the 4 ranks, against one process, and
    # the dry run's long-context cut
    context = context_phase(device)
    mark("context")
    # the dry run: meta counts of the grid, and three cells executed on
    # the card, each count equal to its meta count at the same cut, and
    # the model-axis, long-context and FSDP cuts' ranks
    dryrun_phase(device, axis["dryrun"] + context["dryrun"], dp["dryrun"])
    mark("dry run")
    # the kernel's line: one 1024-frame chunk of the full-width operator,
    # its five conv layers (the main path's largest dispatch); the bound
    # is the larger of their summed bytes and summed operations' times
    main_rows = [rows[s] for s in layers(MAIN_OP)]
    # moe_gmm's entry: granite-moe-3b-a800m's rows (40 experts), and
    # under "jamba" the row of a 2048-token prompt's gate and up products
    # with the launches of jamba's serve
    granite_rows = {k: r for k, r in lm_rows.items()
                    if k[0] != "moe_gmm" or k[1].startswith("E=40 ")}
    hybrid_rows = {k: r for k, r in lm_rows.items()
                   if k[0] == "moe_gmm" and k[1].startswith("E=16 ")}
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
        "grouped": {k: grouped["conv_scorer"][k] for k in (
            "members", "ms", "bound_ms", "library_ms")} | {
            "launches": fleet["fleet_launches"]["conv_scorer_grouped"]},
    }] + [lm_line(name, lm_rows, serve["launches"][name], label) |
          ({"train_launches": training["launches"][name]}
           if name in training["launches"] else {})
          for name, label in (("rmsnorm", "2048x2560 bfloat16"),
                              ("flash_attention", "B=1 S=2048 bfloat16"),
                              ("decode_attention", "bfloat16"))
          if name != "decode_attention"] +
        [lm_line("decode_attention", lm_rows,
                 serve["launches"]["decode_attention"], "bfloat16") | {
            "slice": {"shape": "rows 2048..4095 of 8 rings of 4096, "
                      "with each head's log-sum-exp (the model axis)",
                      "launches": axis["serve"]["launches"][
                          "decode_attention"],
                      **{k: v for k, v in lm_line(
                          "decode_attention_slice", lm_rows, 0,
                          "bfloat16").items()
                         if k in ("max_abs_err", "ms", "plain_ms",
                                  "bound_ms", "bound_by", "library_ms")}},
            "context": context_entry(lm_rows, context["launches"])}] +
        [lm_line("moe_gmm", granite_rows, moe_serve["launches"]["moe_gmm"],
                 "C=512 1536->512 bfloat16") | {
                     "train_launches": training["launches"]["moe_gmm"],
                     "jamba": {
                     "shape": f"E=16 {HYBRID_LABEL}",
                     **lm_line("moe_gmm", hybrid_rows,
                               hybrid_serve["launches"]["moe_gmm"],
                               HYBRID_LABEL)}}] + [{
        "name": "scorer_head", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/scorer_head.cu",
        "replaces": "src/repro/core/runtime.py:200-201 (XLA matmuls, no "
                    "Pallas kernel)",
        "launches": query["scorer_head_launches"], **head_row,
        "grouped": {k: grouped["scorer_head"][k] for k in (
            "members", "ms", "bound_ms")} | {
            "launches": fleet["fleet_launches"]["scorer_head_grouped"]}}] +
        [bwd_line(name, src, fwd, label, bwd_rows,
                  training["launches"][name])
         for name, src, fwd, label in BWD_LINES]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
