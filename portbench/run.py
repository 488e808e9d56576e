"""Run one cell of the port's benchmark once and print its result.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. It builds the port (``src/repro_torch``)
with weights and traffic drawn from ``--seed``, warms up every shape
the cell uses (``setup_s``), measures for ``--seconds``, checks what
the window produced against the plain reference, and prints the result
as the last line of standard output: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each number compared beside its
limit, also the last lines of standard error). It refuses to measure
without an NVIDIA card, and exits non-zero, printing no result, if JAX
or the JAX package is loaded once the window has closed.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the kernels' build cache lives in the checkout (the port's own
# build/repro_torch); CUDA's JIT cache beside it, at a fixed path
os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "cuda_cache")
# cuBLAS's workspace for deterministic training steps, before its first
# handle (the port's launcher sets the same)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
os.environ.setdefault("OMP_NUM_THREADS", "4")
# the package by its name only: a script's own directory on the path
# would let portbench/trace.py stand for the standard library's trace
sys.path[:] = [p for p in sys.path
               if Path(p or ".").resolve() != ROOT / "portbench"]
for p in (ROOT / "src", ROOT):
    sys.path.insert(0, str(p))

import torch  # noqa: E402

from portbench import harness  # noqa: E402


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    chips = harness.cell(harness.manifest(), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} NVIDIA card(s); "
              f"{n} found, nothing measured", file=sys.stderr)
        return 2
    result = harness.execute(args.workload, args.seed, args.seconds,
                             bool(args.trace), "cuda", STARTED)
    loaded = harness.forbidden_loaded()
    if loaded:
        print(f"portbench: {', '.join(loaded)} loaded in the measuring "
              "process; no result", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
