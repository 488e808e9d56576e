"""Training launcher: config-selected arch on one card, fault-tolerant.

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
        --steps 200 --batch 8 --seq 256 --ckpt /tmp/ckpt --resume auto

Ported from ``repro/launch/train.py``, with the same flags plus
``--device`` (the card unless ``--device cpu``): the model built for
training from seed 0, AdamW, the deterministic resumable data pipeline,
atomic checkpoints (and a final one), and SIGTERM-graceful preemption
(checkpoint, then exit), so a preempted job restarted with ``--resume
auto`` continues exactly: the same sample stream, optimizer step and
bits. There is no mesh: the port trains on one device (multi-GPU is a
later slice). The run is in PyTorch's deterministic mode
(``train_step.deterministic``), and cuBLAS's workspace is set for it
before the first handle, so that every step's bits repeat.
"""
from __future__ import annotations

import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse  # noqa: E402
import contextlib  # noqa: E402
import math  # noqa: E402
import signal  # noqa: E402
import sys  # noqa: E402
import time  # noqa: E402
from typing import Callable, Dict, Optional  # noqa: E402

import torch  # noqa: E402

from repro_torch.configs import base as cfgbase  # noqa: E402
from repro_torch.kernels.ops import resolve_device  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.train import checkpoint, data as data_mod  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as steps_mod  # noqa: E402


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", default="none", choices=["none", "auto"])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap


def run(argv=None, wrap_step: Optional[Callable[[int], object]] = None
        ) -> Dict:
    """The training loop; returns what it did: ``start_step``, ``steps``
    run, each step's ``losses`` and ``step_s`` (host seconds, each step
    ending in the loss's copy to the host), ``tokens_per_s`` over the
    steps run, ``stopped`` (by SIGTERM). ``wrap_step(step)``, when given,
    returns a context manager the step runs in (a profiler, a test's
    signal)."""
    args = parser().parse_args(argv)
    cfg = (cfgbase.get_smoke_config(args.arch) if args.smoke
           else cfgbase.get_config(args.arch))
    device = resolve_device(args.device)
    out = {"start_step": 0, "losses": [], "step_s": [], "stopped": False}
    stop = {"now": False}

    def _sigterm(signum, frame):   # preemption: checkpoint then exit
        stop["now"] = True

    previous = signal.signal(signal.SIGTERM, _sigterm)
    try:
        with steps_mod.deterministic():
            _loop(args, cfg, device, out, stop, wrap_step)
    finally:
        signal.signal(signal.SIGTERM, previous)
    return out


def _loop(args, cfg, device, out, stop, wrap_step) -> None:
    gen = torch.Generator(device=device).manual_seed(0)
    model = transformer.init_model(cfg, gen, device, trainable=True)
    params = dict(model.named_parameters())
    ocfg = opt.AdamWConfig(lr=args.lr, total_steps=args.steps)
    ostate = opt.init_opt_state(params)
    pipe = data_mod.TokenPipeline(data_mod.DataConfig(
        vocab_size=cfg.vocab_size, batch=args.batch, seq_len=args.seq))

    start_step = 0
    if args.resume == "auto" and args.ckpt:
        restored = checkpoint.restore_latest(
            args.ckpt, {"params": params, "opt": ostate})
        if restored is not None:
            tree, manifest = restored
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(tree["params"][n])
            ostate = tree["opt"]
            start_step = int(manifest["extra"].get("next_step",
                                                   manifest["step"]))
            print(f"[train] resumed at step {start_step}")
    out["start_step"] = start_step
    train_step = steps_mod.make_train_step(cfg, ocfg)

    def save(step):
        checkpoint.save(args.ckpt, step, {"params": params, "opt": ostate},
                        extra={"next_step": step, "arch": args.arch})

    # real-host step timing of the training harness (as the JAX launcher's
    # waiver says); it never feeds a simulated clock
    t_start = time.perf_counter()  # noqa: DET001
    step = start_step
    for step in range(start_step, args.steps):
        t0 = time.perf_counter()  # noqa: DET001
        with (wrap_step(step) if wrap_step else contextlib.nullcontext()):
            model, ostate, metrics = train_step(model, ostate,
                                                pipe.batch_at(step))
            loss = float(metrics["loss"])
        out["step_s"].append(time.perf_counter() - t0)  # noqa: DET001
        out["losses"].append(loss)
        if not math.isfinite(loss):
            raise FloatingPointError(f"loss {loss} at step {step}")
        if step % args.log_every == 0 or step == args.steps - 1:
            rate = (step - start_step + 1) * args.batch * args.seq / \
                (time.perf_counter() - t_start)  # noqa: DET001
            print(f"[train] step={step} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"tok/s={rate:,.0f}", flush=True)
        if args.ckpt and (step + 1) % args.ckpt_every == 0:
            save(step + 1)
        if stop["now"]:
            print("[train] SIGTERM: checkpointing and exiting")
            if args.ckpt:
                save(step + 1)
            out["stopped"] = True
            break
    n = len(out["step_s"])
    out["steps"] = n
    out["tokens_per_s"] = n * args.batch * args.seq / sum(out["step_s"]) \
        if n else 0.0
    if out["stopped"]:
        return
    if args.ckpt:
        save(step + 1)
    losses = out["losses"]
    if len(losses) >= 2 and losses[-1] >= losses[0]:
        print(f"[train] WARNING: loss did not decrease "
              f"({losses[0]:.3f} -> {losses[-1]:.3f})")


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
