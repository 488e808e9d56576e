"""Spans around the harness's calls into the program, and the reduction
of a device-only ``torch.profiler`` trace to what the per-layer metrics
read.

The profiler traces the card alone (``ProfilerActivity.CUDA``: kernels,
copies, sets), so a traced window keeps the untraced pace: no host op
is recorded. ``Spans`` takes the harness's spans on the host's own
clock, in the time base of the trace's events (``now_s``). ``reduce``
reads the trace's raw events (not ``key_averages``, which builds an
object an event): the device intervals inside the traced window, their
union (``busy_s``, never their sum: overlapping kernels count once),
the device time by kernel name, and each idle gap between device
intervals split by the harness span open over it.
"""
from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch

WINDOW = "portbench.window"


def now_s() -> float:
    """The host's clock in the profiler's time base (the wall clock's
    seconds)."""
    return time.time_ns() * 1e-9


class Spans:
    """The harness's spans of one run: ``span(name)`` notes (name, start,
    end) on ``now_s``'s clock in ``taken`` while the run is traced
    (``on``), else nothing."""

    def __init__(self, on: bool):
        self.on = on
        self.taken: List[Tuple[str, float, float]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        if not self.on:
            yield
            return
        a = now_s()
        try:
            yield
        finally:
            self.taken.append((name, a, now_s()))


def union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def gaps(covered: Sequence[Tuple[float, float]], lo: float,
         hi: float) -> List[Tuple[float, float]]:
    """The parts of [lo, hi) that ``covered`` (disjoint, sorted) leaves."""
    out, t = [], lo
    for a, b in covered:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if hi > t:
        out.append((t, hi))
    return out


def idle_by_span(idle: Sequence[Tuple[float, float]],
                 spans: Sequence[Tuple[str, float, float]]) -> Dict[str, float]:
    """Idle seconds split by the harness span open over them ("host"
    where none is). The harness's spans do not nest; both lists run in
    time order once sorted, so one pass takes them."""
    spans = sorted(spans, key=lambda s: s[1])
    out: Dict[str, float] = {}
    j = 0
    for a, b in idle:
        while j < len(spans) and spans[j][2] <= a:
            j += 1
        t, k = a, j
        while t < b:
            if k < len(spans) and spans[k][1] <= t:
                name, end = spans[k][0], min(spans[k][2], b)
                k += 1
            else:
                name = "host"
                end = min(spans[k][1], b) if k < len(spans) else b
            if end > t:
                out[name] = out.get(name, 0.0) + (end - t)
            t = max(t, end)
    return out


@dataclass
class Summary:
    """What a trace says about its window (seconds)."""
    window_s: float
    busy_s: float
    by_name: Dict[str, float] = field(default_factory=dict)
    idle_by_span: Dict[str, float] = field(default_factory=dict)

    def device_time(self, *substrings: str) -> float:
        """Device seconds of the kernels whose name holds any substring."""
        return sum(t for n, t in self.by_name.items()
                   if any(s in n for s in substrings))

    def breakdown(self, n: int = 10) -> Dict:
        ops = sorted(self.by_name.items(), key=lambda kv: -kv[1])[:n]
        idle = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in ops],
                "idle_gaps": [[k, v] for k, v in idle]}


def summarize(device: Sequence[Tuple[str, float, float]],
              spans: Sequence[Tuple[str, float, float]], lo: float,
              hi: float) -> Summary:
    """Reduce device events (name, start, end) and host spans over the
    window [lo, hi) (one clock, seconds)."""
    by_name: Dict[str, float] = {}
    inside = []
    for name, a, b in device:
        if b <= lo or a >= hi:
            continue
        a, b = max(a, lo), min(b, hi)
        by_name[name] = by_name.get(name, 0.0) + (b - a)
        inside.append((a, b))
    covered = union(inside)
    return Summary(hi - lo, sum(b - a for a, b in covered), by_name,
                   idle_by_span(gaps(covered, lo, hi), spans))


def reduce(prof, spans: Spans) -> Optional[Summary]:
    """A device-only ``torch.profiler.profile``'s raw events reduced over
    the traced window (the ``WINDOW`` span); None where the window is
    missing."""
    window = [(a, b) for n, a, b in spans.taken if n == WINDOW]
    if not window:
        return None
    cuda = torch.autograd.DeviceType.CUDA
    device = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != cuda or e.is_user_annotation():
            continue
        a = e.start_ns() * 1e-9
        device.append((e.name(), a, a + e.duration_ns() * 1e-9))
    return summarize(device, [s for s in spans.taken if s[0] != WINDOW],
                     *window[-1])
