"""Host time of the serving engine's decode tick, for comparing two trees.

    PYTHONPATH=src python benchmarks/torch_serve_tick.py

For each model (h2o-danube-1.8b, granite-moe-3b-a800m; as published,
bf16, random weights from seed 0): ``ServeEngine`` with 8 slots of 4096
ring rows serves 16 requests of 128-2048 prompt tokens (numpy seed 0),
64 greedy tokens each, as ``chip_smoke.py``'s ``serve_phase``. Each round
serves all 16 anew; of ``ROUNDS`` the first warms up (kernel builds,
the allocator) and is not reported. Per round: the host wall of each
decode tick (each ends in the sampler's copy to the host, so the card
has finished), its mean and median. Before the serves, the host time
of one call of the rmsnorm and decode-attention wrappers alone, at
h2o's tick shapes (``wrapper_us``). The ``repro_torch`` imported is whichever
``PYTHONPATH`` names, so one copy of this script times another tree's
engine (``PYTHONPATH=build/parent/src``); run the trees in turns
(parent, change, change, parent) in one call. Prints the card's name and
power limit, then one JSON line. Needs a CUDA card.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

import repro_torch
from repro_torch.configs.base import get_config
from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as da
from repro_torch.kernels import rmsnorm as rms
from repro_torch.models import transformer as tf
from repro_torch.serving.engine import ServeEngine

ARCHS = ("h2o-danube-1.8b", "granite-moe-3b-a800m")
KERNELS = ("rmsnorm", "flash_attention", "decode_attention", "moe_gmm")
ROUNDS = 3


def serve_ticks(arch: str, device: torch.device) -> dict:
    """Every decode tick's host wall (ms) in each round after the
    first."""
    cfg = get_config(arch)
    model = tf.init_model(cfg, torch.Generator(device=device).manual_seed(0),
                          device)
    rng = np.random.default_rng(0)
    lens = rng.integers(128, 2049, size=16)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in lens]
    out = []
    for _ in range(ROUNDS):
        eng = ServeEngine(model, slots=8, cache_len=4096)
        ticks = []
        tick = eng._tick

        def timed_tick(results):
            t = time.perf_counter()  # noqa: DET001 - the tick's host wall
            tick(results)
            ticks.append(1e3 * (time.perf_counter() - t))  # noqa: DET001

        eng._tick = timed_tick
        for p in prompts:
            eng.submit(p, max_new=64)
        eng.run()
        torch.cuda.synchronize(device)
        out.append(ticks)
    del model
    torch.cuda.empty_cache()
    timed = out[1:]
    return {"ticks": [len(r) for r in timed],
            "mean_ms": [statistics.fmean(r) for r in timed],
            "median_ms": [statistics.median(r) for r in timed]}


def wrapper_us(device: torch.device) -> dict:
    """Host µs of one wrapper call, launch included: rmsnorm over an
    8-slot tick's rows (8 x 1 x 2560 bf16) and decode attention over 8
    slots of 32/8 heads of 80 and a 256-row ring (short, so the card
    keeps up). 26 batches of 200 calls, each ended by a sync (fewer
    launches than the queue holds), the first a warm-up; the median
    batch's time a call."""
    x = torch.randn(8, 1, 2560, device=device, dtype=torch.bfloat16)
    scale = torch.ones(2560, device=device)
    q = torch.randn(8, 32, 80, device=device, dtype=torch.bfloat16)
    kv = torch.randn(8, 256, 8, 80, device=device, dtype=torch.bfloat16)
    pos = torch.full((8,), 255, dtype=torch.int32, device=device)
    calls = {"rmsnorm": lambda: rms.rmsnorm(x, scale),
             "decode_attention": lambda: da.decode_attention(q, kv, kv, pos)}
    out = {}
    for name, call in calls.items():
        batches = []
        for _ in range(26):
            torch.cuda.synchronize(device)
            t = time.perf_counter()  # noqa: DET001 - host time of calls
            for _ in range(200):
                call()
            batches.append((time.perf_counter() - t) / 200)  # noqa: DET001
        torch.cuda.synchronize(device)
        out[name] = 1e6 * statistics.median(batches[1:])
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    device = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    with ThreadPoolExecutor(len(KERNELS)) as pool:   # nvcc in parallel
        list(pool.map(build.build, KERNELS))
    res = {"tree": repro_torch.__file__, "torch": torch.__version__,
           "wrapper_us": wrapper_us(device)}
    for arch in ARCHS:
        res[arch] = serve_ticks(arch, device)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
