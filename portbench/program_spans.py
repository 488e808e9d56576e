"""The program's own spans (``repro_torch.spans``) of one traced run, for
the per-layer metrics that read them.

The program records spans exactly while a ``torch.profiler`` records, so
in a ``--trace 1`` run on the card and in no other. ``taken(run)`` keeps
those that open inside the harness's window span (``trace.WINDOW``; both
on ``time.time_ns``'s clock), read once a run; a reader sums a quantity
over them and divides by the window's steps. Every function gives None
where there is nothing to read: a program without the recorder, a run
not traced, the CPU (no device times).
"""
from __future__ import annotations

from typing import Dict, List, Optional

from portbench import trace as T

KEY = "program_spans"


def taken(run) -> Optional[List]:
    """The program's spans that open inside the run's window, or None."""
    if KEY not in run.extra:
        run.extra[KEY] = _inside_window(run)
    return run.extra[KEY]


def _inside_window(run) -> Optional[List]:
    try:
        from repro_torch import spans
    except ImportError:
        return None
    got = spans.taken()
    spans.clear()
    window = [(a, b) for n, a, b in run.spans.taken if n == T.WINDOW]
    if not window:
        return None
    lo, hi = window[-1]
    inside = [s for s in got if lo <= s.start_ns * 1e-9 < hi]
    return inside or None


def named(run, *names) -> List:
    return [s for s in taken(run) or () if s.name in names]


def host_ms_per_step(run, *names) -> Optional[float]:
    """Host ms a step inside the spans ``names``."""
    got = named(run, *names)
    if not got:
        return None
    return sum(s.end_ns - s.start_ns for s in got) * 1e-6 / run.record.steps


def device_ms_per_step(run, name: str, less: str = None) -> Optional[float]:
    """Device ms a step between the events of the spans ``name``; with
    ``less``, each one's self time: less the device time of its children
    named ``less``."""
    got = named(run, name)
    if not got or any(s.device_ms is None for s in got):
        return None
    total = sum(s.device_ms for s in got)
    if less is not None:
        mine = {s.id for s in got}
        total -= sum(s.device_ms for s in named(run, less)
                     if s.parent in mine)
    return total / run.record.steps


def outside(run, got: List, name: str) -> List:
    """The spans of ``got`` with no ancestor named ``name``."""
    ids: Dict[int, object] = {s.id: s for s in taken(run) or ()}

    def under(s):
        while s.parent is not None and s.parent in ids:
            s = ids[s.parent]
            if s.name == name:
                return True
        return False
    return [s for s in got if not under(s)]
