"""Training launcher: config-selected arch, data-parallel, fault-tolerant.

    PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-125m \
        --steps 200 --batch 8 --seq 256 --ckpt /tmp/ckpt --resume auto
    PYTHONPATH=src python -m torch.distributed.run --nproc-per-node 2 \
        -m repro_torch.launch.train --arch granite-moe-3b-a800m \
        --batch 8 --seq 1024 --dist-backend nccl

Ported from ``repro/launch/train.py``, with the same flags plus
``--device`` (the card unless ``--device cpu``): the model built for
training from seed 0, AdamW, the deterministic resumable data pipeline,
atomic checkpoints (and a final one), and SIGTERM-graceful preemption
(checkpoint, then exit), so a preempted job restarted with ``--resume
auto`` continues exactly: the same sample stream, optimizer step and
bits.

Under ``torch.distributed.run`` (torchrun; ``RANK``, ``WORLD_SIZE`` and
``LOCAL_RANK`` in the environment) the run is data-parallel over the
ranks, placed as the JAX launcher places it (FSDP over "data"), with the
backend ``--dist-backend`` names (NCCL by default; gloo too, e.g. for
two ranks sharing one card, which NCCL refuses; a backend that fails
raises, no other is tried): each rank builds its slice of the model
(``transformer.init_model(..., mesh=...)``: every weight with an
"embed" dim and its AdamW moments sliced over the ranks, the rest
whole), trains on its rows of the global ``--batch``
(``train_step.shard_batch``; a batch that does not divide raises) on
``--device``, by default ``cuda:LOCAL_RANK`` where there are several
cards, gathers each block's weights where the block runs, and reduces
the gradients in a fixed order, so the ranks' slices together are the
parameters one process would hold. The checkpoints hold the whole tree:
each sliced leaf is gathered in rank order and rank 0 writes it while
the others wait, and a restore keeps each rank's slice, so a checkpoint
restores at any world size; a SIGTERM on any rank stops every rank
after the same step (a stop flag is all-reduced every step); and
``--resume auto`` at the same world size repeats the uninterrupted run
bit for bit. One rank, or no process group, is the plain trainer. A
caller that has set up the default process group itself (tests) gets it
used as it is. The run is in PyTorch's deterministic mode
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
from datetime import timedelta  # noqa: E402
from typing import Callable, Dict, Optional  # noqa: E402

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from repro_torch.configs import base as cfgbase  # noqa: E402
from repro_torch.kernels.ops import resolve_device  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
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
                    help="cuda (the default; cuda:LOCAL_RANK where there "
                         "are several cards) or cpu")
    ap.add_argument("--dist-backend", default="nccl",
                    choices=["nccl", "gloo"],
                    help="the process group's backend under torchrun")
    ap.add_argument("--dist-init", default="env://",
                    help="the process group's init method under torchrun")
    ap.add_argument("--dist-timeout", type=float, default=600.0,
                    help="seconds a collective may wait")
    return ap


def _distributed(args):
    """(device, whether this call made the default process group): the
    group torchrun's environment asks for, set up with ``args``'
    backend, or the caller's own; none without either."""
    made = not dist.is_initialized() and "WORLD_SIZE" in os.environ
    world = dist.get_world_size() if dist.is_initialized() else \
        int(os.environ.get("WORLD_SIZE", "1"))
    device = _device(args, world)
    if device.type == "cuda" and device.index is not None:
        torch.cuda.set_device(device)     # NCCL's device, before the group
    if made:
        dist.init_process_group(
            args.dist_backend, init_method=args.dist_init,
            rank=int(os.environ["RANK"]), world_size=world,
            timeout=timedelta(seconds=args.dist_timeout))
    return device, made


def _device(args, world: int) -> torch.device:
    if args.device is None and world > 1 and torch.cuda.device_count() > 1:
        return torch.device(f"cuda:{os.environ.get('LOCAL_RANK', '0')}")
    return resolve_device(args.device)


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
    device, made = _distributed(args)
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
        if made:
            dist.destroy_process_group()
    return out


def _stop_everywhere(stop: bool, mesh, device) -> bool:
    """Whether any rank was asked to stop (a max over the ranks)."""
    if mesh.group is None:
        return stop
    flag = torch.tensor([int(stop)], device=device)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=mesh.group)
    return bool(flag.item())


def _loop(args, cfg, device, out, stop, wrap_step) -> None:
    mesh = make_local_mesh(device)
    group = mesh.group
    out["world_size"] = mesh.processes
    gen = torch.Generator(device=device).manual_seed(0)
    model = transformer.init_model(cfg, gen, device, trainable=True,
                                   mesh=mesh)
    params = dict(model.named_parameters())
    ocfg = opt.AdamWConfig(lr=args.lr, total_steps=args.steps)
    ostate = opt.init_opt_state(params)
    pipe = data_mod.TokenPipeline(data_mod.DataConfig(
        vocab_size=cfg.vocab_size, batch=args.batch, seq_len=args.seq))

    start_step = 0
    if args.resume == "auto" and args.ckpt:
        restored = checkpoint.restore_latest(
            args.ckpt, {"params": params, "opt": ostate},
            shard=lambda key, t: model.slice_of(key.rpartition("/")[2], t))
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
    train_step = steps_mod.make_train_step(
        cfg, ocfg, mesh=mesh if group is not None else None)
    log = mesh.rank == 0

    # the tree's leaves each rank holds a slice of, and their dims
    sliced = {f"{k}/{n}": d for n, d in model.data_dims.items()
              for k in ("params", "opt/m", "opt/v")}

    def save(step):
        checkpoint.save(args.ckpt, step, {"params": params, "opt": ostate},
                        extra={"next_step": step, "arch": args.arch},
                        group=group, sliced=sliced)

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
        if log and (step % args.log_every == 0 or step == args.steps - 1):
            rate = (step - start_step + 1) * args.batch * args.seq / \
                (time.perf_counter() - t_start)  # noqa: DET001
            print(f"[train] step={step} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"tok/s={rate:,.0f}", flush=True)
        if args.ckpt and (step + 1) % args.ckpt_every == 0:
            save(step + 1)
        if _stop_everywhere(stop["now"], mesh, device):
            if log:
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
    if log and len(losses) >= 2 and losses[-1] >= losses[0]:
        print(f"[train] WARNING: loss did not decrease "
              f"({losses[0]:.3f} -> {losses[-1]:.3f})")


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
