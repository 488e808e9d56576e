"""One run of one cell, driven by data.

``BENCHMARK.json`` names the cell's configuration, traffic and metrics;
each is a file of its own that this module finds by name:

- the configuration: the manifest's ``file`` (``portbench/configs/``);
- the traffic mix: ``portbench/traffic/<traffic>.json``, whose
  ``driver`` names the driver module ``portbench/drivers/<driver>.py``;
- each metric, end to end or per layer: ``portbench/metrics/<name>.py``,
  a reader whose ``read(run)`` gives its value, or None where it finds
  nothing to read (the metric is then left out of the result);
- the limits of the comparison that decides ``correct``:
  ``portbench/limits/<cell>.json``.

A driver has ``setup(run)`` (the program built from the seed and every
shape of the cell warmed up), ``window(run, state)`` (the measured
window; returns its record), ``close(run, state)`` (the program's state
freed) and ``check(run)`` (the numbers compared, by name, from the
reference after the window). A run is ``execute(...)``; ``run.py`` is
its command line.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

import torch

from portbench import trace as T

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
SHOWN = ("setup", "trace_s", "still")   # run.extra, on stderr


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def manifest() -> Dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(man: Dict, name: str) -> Dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(man: Dict, name: str) -> Dict:
    for c in man["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> Dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(cell_name: str) -> Dict[str, float]:
    return load_json(HERE / "limits" / f"{cell_name}.json")


def driver(kind: str):
    return importlib.import_module(f"portbench.drivers.{kind}")


def reader(metric: str) -> Callable[["Run"], Optional[float]]:
    """``portbench/metrics/<metric>.py``'s ``read``."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(man: Dict, cell_name: str, traced: bool) -> List[Dict]:
    """The metrics a run of the cell reports: its end-to-end metrics
    untraced, its per-layer metrics traced (those that list the cell, or
    list none and move an end-to-end metric the cell reports)."""
    def mine(m):
        return cell_name in m["workloads"] if "workloads" in m else None
    e2e = [m for m in man["end_to_end"] if mine(m) is not False]
    if not traced:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in man["per_layer"]
            if mine(m) or (mine(m) is None and m["moves"] in reported)]


@dataclass
class Run:
    """Everything a driver and a metric reader may read of one run."""
    cell: str
    cfg: Dict
    traffic: Dict
    seed: int
    seconds: float
    traced: bool
    device: torch.device
    started: float
    spans: T.Spans = None
    record: Any = None                 # the window's record (the driver module's)
    summary: Optional[T.Summary] = None
    setup_s: Optional[float] = None
    device_name: str = "cpu"
    extra: Dict = field(default_factory=dict)

    def span(self, name: str):
        return self.spans.span(name)

    def mark(self, phase: str) -> None:
        """Note the host seconds since the last mark (or the process's
        start) under ``phase``, for the run's diagnostics line."""
        now = time.perf_counter()
        last = self.extra.get("_last", self.started)
        self.extra.setdefault("setup", {})[phase] = round(now - last, 3)
        self.extra["_last"] = now


def forbidden_loaded() -> List[str]:
    """Modules of JAX or the JAX package in this process, by whole
    top-level name."""
    return sorted({n.partition(".")[0] for n in list(sys.modules)}
                  & set(FORBIDDEN))


def _profiler(device: torch.device):
    """A trace of the card alone; none on the CPU."""
    if device.type != "cuda":
        return None
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])


def execute(name: str, seed: int, seconds: float, traced: bool, device,
            started: float, overrides: Optional[Dict] = None,
            keep: Optional[List] = None) -> Dict:
    """One run of cell ``name``; returns the result line's object.
    ``overrides``: keys replaced in the configuration and the traffic
    (``{"config": {...}, "traffic": {...}}``), for the CPU tests;
    ``keep``: a list the ``Run`` is appended to (``calibrate.py``)."""
    man = manifest()
    w = cell(man, name)
    overrides = overrides or {}
    cfg = {**config(man, w["config"]), **overrides.get("config", {})}
    tr = {**traffic(w["traffic"]), **overrides.get("traffic", {})}
    device = torch.device(device)
    run = Run(name, cfg, tr, seed, seconds, traced, device, started,
              spans=T.Spans(traced))
    if keep is not None:
        keep.append(run)
    if device.type == "cuda":
        run.device_name = torch.cuda.get_device_name(device)
    drv = driver(tr["driver"])
    run.mark("imports")
    state = drv.setup(run)
    prof = _profiler(device) if traced else None
    if prof is not None:
        prof.start()
    # no collector pauses inside the window: what set-up made is frozen,
    # and the window makes no cycles
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        with run.span(T.WINDOW):
            run.record = drv.window(run, state)
    finally:
        gc.enable()
        gc.unfreeze()
    if prof is not None:
        t = time.perf_counter()
        prof.stop()
        run.summary = T.reduce(prof, run.spans)
        del prof
        run.extra["trace_s"] = time.perf_counter() - t
    run.setup_s = run.record.t0 - started
    peak = torch.cuda.max_memory_allocated(device) \
        if device.type == "cuda" else 0
    drv.close(run, state)
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks = drv.check(run)
    print(f"portbench: {name} seed {seed}: set-up {run.setup_s:.3f} s, "
          f"window {run.record.t_end - run.record.t0:.3f} s, check "
          f"{time.perf_counter() - t_check:.3f} s, "
          f"{ {k: v for k, v in run.extra.items() if k in SHOWN} }",
          file=sys.stderr)
    lim = limits(name)
    out_checks = {k: {"value": v, "limit": lim[k]} for k, v in checks.items()}
    correct = run.record.failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in out_checks.values())
    metrics = {}
    for m in metrics_of(man, name, traced):
        v = reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": run.device_name, "count": 1, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": run.record.attempted,
              "failed": run.record.failed, "metrics": metrics, "device": dev}
    if traced and run.summary is not None:
        dev["busy_s"] = run.summary.busy_s
        dev["window_s"] = run.summary.window_s
        result["breakdown"] = run.summary.breakdown()
    result["checks"] = out_checks
    return result
