"""End-to-end LM training over the zoo, on the PyTorch/CUDA port.

    # CPU demo: xlstm-125m's smoke config, the loss falling
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu

    # on the card (every norm, prefill attention and MoE expert product,
    # and their gradients, run hand-written CUDA kernels)
    PYTHONPATH=src python examples/torch_train_lm.py --arch granite-moe-3b-a800m

    # a published config at full width on the card
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch granite-moe-3b-a800m --steps 10 --batch 4 --seq 1024

The counterpart of ``examples/train_lm.py``, with its flags plus
``--device`` (the card unless ``cpu`` is asked for). It wraps
``repro_torch.launch.train``: AdamW, the deterministic resumable data
pipeline, atomic checkpoints (into a temporary directory, halfway and at
the end), SIGTERM-graceful preemption."""
import argparse
import sys
import tempfile

sys.path.insert(0, "src")

from repro_torch.launch import train as train_mod  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="xlstm-125m")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--full-config", action="store_true",
                    help="train the published full config (on the card)")
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card; raises without one)")
    args = ap.parse_args()

    with tempfile.TemporaryDirectory() as ckpt:
        argv = ["--arch", args.arch,
                "--steps", str(args.steps),
                "--batch", str(args.batch),
                "--seq", str(args.seq),
                "--lr", str(args.lr),
                "--ckpt", ckpt, "--ckpt-every", str(max(args.steps // 2, 1)),
                "--resume", "auto", "--log-every", "10"]
        if not args.full_config:
            argv.append("--smoke")
        if args.device:
            argv += ["--device", args.device]
        out = train_mod.run(argv)
    print(f"loss {out['losses'][0]:.4f} -> {out['losses'][-1]:.4f} over "
          f"{out['steps']} steps, {out['tokens_per_s']:,.0f} tokens/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
