"""Batched serving with continuous batching, on the PyTorch/CUDA port.

    PYTHONPATH=src python examples/torch_serve_lm.py --arch jamba-v0.1-52b
    PYTHONPATH=src python examples/torch_serve_lm.py --arch xlstm-125m \\
        --device cpu

The counterpart of ``examples/serve_lm.py``, with its flags plus
``--device`` (the card unless ``cpu`` is asked for): a zoo model at its
reduced (smoke) size with random weights, eight prompts of 4-23 tokens
sharing 4 decode slots; a finished sequence frees its slot at once for a
waiting request. On the card every norm, prefill attention, decode
attention and MoE expert product runs a hand-written CUDA kernel."""
import argparse
import sys
import time

sys.path.insert(0, "src")

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs.base import ARCH_IDS, get_smoke_config  # noqa: E402
from repro_torch.kernels.ops import resolve_device  # noqa: E402
from repro_torch.models import transformer  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="h2o-danube-1.8b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cpu or cuda (default: the card; raises without one)")
    args = ap.parse_args()

    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch).scaled(remat=False)
    print(f"arch={args.arch} (reduced config: {cfg.num_layers}L "
          f"d={cfg.d_model} vocab={cfg.vocab_size}) on {device}")
    model = transformer.init_model(cfg, torch.Generator().manual_seed(0),
                                   device)
    eng = ServeEngine(model, slots=args.slots, cache_len=256,
                      temperature=args.temperature, device=device)
    rng = np.random.default_rng(0)
    t0 = time.time()
    rids = []
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=rng.integers(4, 24))
        rids.append(eng.submit(prompt, max_new=args.max_new))
    results = eng.run()
    dt = time.time() - t0
    total_new = sum(len(v) for v in results.values())
    for rid in rids:
        out = results[rid]
        print(f"  req {rid}: {len(out)} tokens -> "
              f"{out[:8]}{'...' if len(out) > 8 else ''}")
    print(f"{args.requests} requests, {total_new} tokens in {dt:.1f}s "
          f"({total_new / dt:.1f} tok/s on {device} with {args.slots} slots)")


if __name__ == "__main__":
    main()
