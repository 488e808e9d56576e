"""The readings the limits of ``correct`` are set from, for one cell,
over many seeds in one process (set-up is long):

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,3 \
        --seconds 6 [--control 3] [--faults 3] [--out FILE]

For each seed: a run of the cell as ``run.py`` makes it (a short window
at the cell's own load) and the program's numbers; for the first
``--control`` seeds the control's (the reference in fp8 in the
program's place), for the first ``--faults`` seeds each fault's the
driver plants (``faults``). One JSON line a seed, on standard output
and appended to ``--out``.
"""
from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import run as entry  # noqa: E402,F401  (the run's environment and paths)
from portbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", type=int, default=0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        keep = []
        t = time.perf_counter()
        res = harness.execute(args.workload, seed, args.seconds, False, "cuda",
                              t, keep=keep)
        run = keep[0]
        drv = harness.driver(run.traffic["driver"])
        line = {"workload": args.workload, "seed": seed,
                "correct": res["correct"],
                "program": {k: c["value"] for k, c in res["checks"].items()},
                "metrics": {k: m["value"] for k, m in res["metrics"].items()}}
        if i < args.control:
            line["control"] = drv.control(run)
        if i < args.faults:
            line["faults"] = drv.faults(run)
        line["seconds"] = time.perf_counter() - t
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        del keep, run
    return 0


if __name__ == "__main__":
    sys.exit(main())
