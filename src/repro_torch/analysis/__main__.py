"""CLI: ``python -m repro_torch.analysis [paths...]``.

Ported from ``repro/analysis/__main__.py``; the default waiver file is
the port's ``analysis-waivers-torch.txt``.

Exit status: 0 = clean (waived findings don't count), 1 = violations,
2 = usage error. ``--format json`` emits a machine-readable report for
CI annotation; ``--list-rules`` documents every registered rule and the
invariant it protects.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import Optional, Sequence

from repro_torch.analysis import RULES, run_paths


def _list_rules() -> str:
    out = []
    for rid in sorted(RULES):
        rule = RULES[rid]
        out.append(f"{rid}  {rule.name}")
        out.append(f"    applies to: {', '.join(rule.default_paths)}")
        out.append(f"    invariant:  {rule.invariant}")
    out.append("TRC003, TRC004  (the JAX package's static-argument and "
               "donation rules)")
    out.append("    no counterpart: an eager PyTorch call has no static "
               "arguments keying a compilation cache, and no buffer "
               "donation")
    return "\n".join(out)


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static analysis of the port's invariants "
                    "(determinism, stepper purity, launch hygiene).")
    parser.add_argument("paths", nargs="*",
                        default=["src", "tests", "benchmarks"],
                        help="files/directories to analyze "
                             "(default: src tests benchmarks)")
    parser.add_argument("--format", choices=("text", "json"),
                        default="text")
    parser.add_argument("--waivers", type=Path, default=None,
                        help="waiver file (default: "
                             "<root>/analysis-waivers-torch.txt if "
                             "present)")
    parser.add_argument("--root", type=Path, default=None,
                        help="repo root for relative paths (default: cwd)")
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule-id globs "
                             "(e.g. 'DET*,STP001')")
    parser.add_argument("--show-waived", action="store_true",
                        help="also print waived findings")
    parser.add_argument("--list-rules", action="store_true")
    args = parser.parse_args(argv)

    if args.list_rules:
        print(_list_rules())
        return 0

    rules = [g.strip() for g in args.rules.split(",")] if args.rules \
        else None
    try:
        report = run_paths(args.paths, root=args.root,
                           waiver_file=args.waivers, rules=rules)
    except (FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 2

    if args.format == "json":
        print(json.dumps(report.to_json(), indent=2))
    else:
        print(report.render_text(show_waived=args.show_waived))
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
