"""AdamW's update kernel against the eager loop it replaced, on the card.

    PYTHONPATH=src python -m benchmarks.torch_adamw
    PYTHONPATH=src python -m benchmarks.torch_adamw --cells h2o-danube-1.8b --iters 5

For each benchmark configuration (``portbench/configs/<name>.json``, the
parameters a training cell updates: float32, every layer), on the same
random parameters, gradients and moments on the card, in one process:

* ``update``: the kernel (``kernels/adamw.adamw_update``, one launch),
  the plain loop (``kernels/ref.adamw_update``, ~18 eager kernels a
  parameter and three host scalars copied to the card) and PyTorch's
  fused AdamW (``torch._fused_adamw_``, which decays every tensor; the
  yardstick, never called by the port), in turns (loop, kernel,
  library, library, kernel, loop);
* ``step``: the whole of ``optimizer.apply_updates`` (the global norm,
  the clip factor and the update through the kernel) against the same
  norm and factor followed by the loop, which is the step before the
  kernel, in turns;
* the kernel's first step bit for bit the loop's on the first and last
  four tensors (fresh copies).

Each time is device ms a call from CUDA events around ``--iters`` calls
after a warm-up, the host issuing them as a training step does (the
loop's host scalars make it wait for the card). Beside each: GB/s by
the update's bytes (28 an element in float32: p, g, m and v read, p, m
and v written; the step's 32 with the norm's read of g) and its share
of 3.35 TB/s. The card's name and power limit come first; the rows go to
stdout and, as JSON, to ``results/torch_adamw.json``. Needs a CUDA card
and nvcc.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import harness, port  # noqa: E402
from repro_torch.kernels import adamw, ref  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

PEAK_BYTES_PER_S = 3.35e12
CELLS = ("h2o-danube-1.8b", "granite-moe-3b-a800m")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def time_ms(fn, iters: int) -> float:
    """Mean device ms of ``fn`` over ``iters`` calls after two more."""
    for _ in range(2):
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


def device_ops(fn) -> dict:
    """The kernels and copies one call of ``fn`` puts on the card, by a
    device-only profiler trace (None where the trace comes back empty)."""
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kinds = {"kernels": 0, "copies": 0}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kinds["copies" if "memcpy" in e.name.lower() else "kernels"] += 1
    return kinds if sum(kinds.values()) else None


def rate(ms: float, nbytes: int) -> dict:
    gbs = nbytes / (ms * 1e-3) / 1e9
    return {"ms": ms, "GB_per_s": gbs, "share_of_peak": gbs * 1e9 /
            PEAK_BYTES_PER_S}


def tensors(name: str, device):
    """The configuration's trainable parameters as the benchmark holds them
    (float32), each with a gradient, m and v, drawn on the card; and the
    decay flags."""
    cfg = harness.config(harness.manifest(), name)
    model = tf.init_model(port.model_config(cfg), None, "meta",
                          trainable=True)
    named = [(n, tuple(p.shape)) for n, p in model.named_parameters()]
    mask = model.decay_mask()
    gen = torch.Generator(device=device).manual_seed(0)

    def draw(s, scale):
        return scale * torch.randn(s, generator=gen, device=device)
    p = [draw(s, 0.02) for _, s in named]
    g = [draw(s, 1e-4) for _, s in named]
    m = [draw(s, 1e-5) for _, s in named]
    v = [draw(s, 1e-9).abs() for _, s in named]
    return [n for n, _ in named], p, g, m, v, [mask[n] for n, _ in named]


def library_update(p, g, m, v, hp):
    """PyTorch's fused AdamW over the same tensors, or None where this
    PyTorch has none."""
    fused = getattr(torch, "_fused_adamw_", None)
    if fused is None:
        return None
    steps = [torch.ones((), device=p[0].device) for _ in p]

    def run():
        fused(p, g, m, v, [], steps, lr=hp["lr"], beta1=hp["b1"],
              beta2=hp["b2"], weight_decay=hp["wd"], eps=hp["eps"],
              amsgrad=False, maximize=False)
    try:
        run()
    except (RuntimeError, TypeError) as e:
        print(f"  torch._fused_adamw_ not timed: {e}")
        return None
    return run


def measure(name: str, iters: int) -> dict:
    device = torch.device("cuda")
    names, p, g, m, v, decay = tensors(name, device)
    n = sum(t.numel() for t in p)
    cfg = opt.AdamWConfig()
    lr = opt.schedule(cfg, 200)
    b1c, b2c = (1 - opt._f32(b) ** 200 for b in (cfg.b1, cfg.b2))
    hp = {"lr": float(lr), "b1": cfg.b1, "b2": cfg.b2, "eps": cfg.eps,
          "wd": cfg.weight_decay}
    scale = torch.ones((), device=device)
    args = (cfg.b1, cfg.b2, cfg.eps, cfg.weight_decay)

    # the first step's bits, on copies of the first and last four tensors
    pick = list(range(4)) + list(range(len(p) - 4, len(p)))
    a = [[t[i].clone() for i in pick] for t in (p, m, v)]
    b = [[t[i].clone() for i in pick] for t in (p, m, v)]
    gs, ds = [g[i] for i in pick], [decay[i] for i in pick]
    adamw.adamw_update(a[0], gs, a[1], a[2], ds, scale, lr, b1c, b2c, *args)
    ref.adamw_update(b[0], gs, b[1], b[2], ds, scale, lr, b1c, b2c, *args)
    equal = all(torch.equal(x, y) for xs, ys in zip(a, b)
                for x, y in zip(xs, ys))
    del a, b

    def kernel():
        adamw.adamw_update(p, g, m, v, decay, scale, lr, b1c, b2c, *args)

    def loop():
        ref.adamw_update(p, g, m, v, decay, scale, lr, b1c, b2c, *args)
    library = library_update(p, g, m, v, hp)
    grads = dict(zip(names, g))
    params = dict(zip(names, p))
    state = opt.OptState(199, dict(zip(names, m)), dict(zip(names, v)))
    flags = dict(zip(names, decay))

    def step_kernel():
        opt.apply_updates(cfg, params, grads, state, decay=flags)

    def step_loop():
        gn = opt.global_norm(grads)
        sc = torch.clamp(cfg.clip_norm / (gn + 1e-9), max=1.0)
        ref.adamw_update(p, g, m, v, decay, sc, lr, b1c, b2c, *args)

    launched = {"loop": device_ops(loop), "kernel": device_ops(kernel)}
    order = ["loop", "kernel"] + (["library", "library"] if library else []) \
        + ["kernel", "loop"]
    fns = {"loop": loop, "kernel": kernel, "library": library}
    times = {k: [] for k in fns if fns[k]}
    for k in order:
        times[k].append(time_ms(fns[k], iters))
    steps = {"loop": [], "kernel": []}
    for k, fn in (("loop", step_loop), ("kernel", step_kernel),
                  ("kernel", step_kernel), ("loop", step_loop)):
        steps[k].append(time_ms(fn, iters))
    row = {"config": name, "tensors": len(p), "elements": n,
           "equal_first_step": equal, "device_ops_a_call": launched,
           "bound_update_ms": 28 * n / PEAK_BYTES_PER_S * 1e3,
           "bound_step_ms": 32 * n / PEAK_BYTES_PER_S * 1e3}
    for k, ts in times.items():
        row[f"update_{k}"] = rate(min(ts), 28 * n) | {"runs_ms": ts}
    for k, ts in steps.items():
        row[f"step_{k}"] = rate(min(ts), 32 * n) | {"runs_ms": ts}
    del p, g, m, v, params, grads, state
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="*", default=list(CELLS),
                    help="benchmark configurations to take the parameters of")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    print(f"card: {card_line()}; torch {torch.__version__}")
    t0 = time.perf_counter()
    rows = []
    for name in args.cells:
        row = measure(name, args.iters)
        rows.append(row)
        print(json.dumps(row))
    out = ROOT / "results" / "torch_adamw.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"card": card_line(), "rows": rows}, indent=1))
    print(f"torch_adamw: done in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
