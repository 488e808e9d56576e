"""Spans inside the port's program, on the profiler's clock.

The recorder is on exactly while a ``torch.profiler`` records: ``span``
reads ``torch.autograd.profiler._is_profiler_enabled``, which the
profiler sets when it starts and clears when it stops, and while it is
off returns one shared null context (one flag read, nothing allocated).
So a traced run is traced inside the program too, and an untraced run
records nothing; no flag, argument or environment variable turns it on.

A span records its name; its parent, the innermost span open at its
start, from one stack for the whole process (autograd runs the backward,
and a checkpoint's recompute, on a thread of its own while the caller
waits); its training step (given, or its parent's); its host start and
end from ``time.time_ns()``, the profiler's time base; on a CUDA device
a pair of timing events recorded on the current stream at its start and
end; and its counts, kept as they are given (device tensors stay on the
device). Nothing waits for the card while spans are recorded: ``taken()``
synchronises and resolves them when they are read, ``clear()`` forgets
them. A span closes in ``__exit__``, which runs when its body raises
too: a non-reentrant checkpoint ends a recompute by raising inside it.

The spans of the port (each read by a per-layer metric of the benchmark):
``train.input``, ``train.fwd``, ``train.bwd``, ``train.optimizer``
(``train/train_step.py``), ``train.remat`` (``models/transformer.py``),
``moe.dispatch``, ``moe.combine`` and ``moe.bwd`` (``models/moe.py``).
"""
from __future__ import annotations

import itertools
import time
from typing import Any, Dict, List, Optional

import torch
import torch.autograd.profiler as _profiler


class _Null:
    """The span while the recorder is off: enters, exits and counts
    nothing; false, so a site can skip work only a record needs."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def count(self, **counts) -> None:
        pass


NULL = _Null()
_NULL_PAIR = (NULL, NULL)

_open: List["Span"] = []      # the open spans, innermost last
_done: List["Span"] = []      # the closed spans, in the order they closed
_ids = itertools.count()


class Span:
    """One recorded span. After ``taken()``: ``id``, ``name``, ``parent``
    (the enclosing span's id, or None), ``step``, ``start_ns`` and
    ``end_ns`` (host, ``time.time_ns``), ``device_ms`` (between its events,
    None off CUDA) and ``counts`` (ints)."""

    def __init__(self, name: str, step: Optional[int] = None, device=None):
        self.id = next(_ids)
        self.name, self.step = name, step
        self.parent: Optional[int] = None
        self.start_ns = self.end_ns = None
        self.device_ms: Optional[float] = None
        self.counts: Dict[str, Any] = {}
        self._events = None
        self._stream = None
        if device is not None and torch.device(device).type == "cuda":
            self._stream = torch.cuda.current_stream(device)
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))

    def count(self, **counts) -> None:
        """Add counts (ints or device tensors, read in ``taken()``)."""
        self.counts.update(counts)

    def __enter__(self):
        if _open:
            self.parent = _open[-1].id
            if self.step is None:
                self.step = _open[-1].step
        self.start_ns = time.time_ns()  # noqa: DET001
        if self._events is not None:
            self._events[0].record(self._stream)
        _open.append(self)
        return self

    def __exit__(self, *exc):
        if self._events is not None:
            self._events[1].record(self._stream)
        self.end_ns = time.time_ns()  # noqa: DET001
        # innermost as a rule; a span closed by a hook may not be
        for i in range(len(_open) - 1, -1, -1):
            if _open[i] is self:
                del _open[i]
                break
        _done.append(self)
        return False


def span(name: str, step: Optional[int] = None, device=None):
    """A span ``name`` to enter with ``with``: timed on the host, and on
    ``device``'s current stream too where ``device`` is a CUDA device;
    ``step``: its training step (else its parent's). Counts are added
    inside it (``Span.count``), where the record is worth their cost:
    ``if sp: sp.count(...)``. The shared ``NULL`` while the recorder is
    off (one flag read: no keyword dict either)."""
    if not _profiler._is_profiler_enabled:
        return NULL
    return Span(name, step, device)


def _null_pair():
    return _NULL_PAIR


def recompute(name: str, device):
    """A ``context_fn`` for ``torch.utils.checkpoint(...,
    use_reentrant=False)``: nothing around the forward, and a span
    ``name`` around each recompute in the backward (while the recorder
    is off, a pair of ``NULL``)."""
    if not _profiler._is_profiler_enabled:
        return _null_pair
    return lambda: (NULL, Span(name, device=device))


def around_backward(name: str, output: torch.Tensor, inp: torch.Tensor,
                    device=None) -> None:
    """A span ``name`` over the backward from ``output``'s gradient to
    ``inp``'s: a hook on the first opens it, one on the second closes
    it. Registers nothing while the recorder is off, or where either
    tensor takes no gradient."""
    if not (_profiler._is_profiler_enabled and output.requires_grad
            and inp.requires_grad):
        return
    sp = Span(name, device=device)

    def opened(grad):
        if sp.start_ns is None:
            sp.__enter__()

    def closed(grad):
        if sp.start_ns is not None and sp.end_ns is None:
            sp.__exit__(None, None, None)

    output.register_hook(opened)
    inp.register_hook(closed)


def taken() -> List[Span]:
    """The closed spans, in the order they closed, each one's device time
    resolved (its end event waited for) and its counts read as ints."""
    for s in _done:
        if s._events is not None:
            s._events[1].synchronize()
            s.device_ms = s._events[0].elapsed_time(s._events[1])
            s._events = s._stream = None
        s.counts = {k: int(v) for k, v in s.counts.items()}
    return list(_done)


def clear() -> None:
    """Forget the closed spans."""
    _done.clear()
