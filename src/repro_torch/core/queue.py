"""Asynchronous ranked upload queue (§3 notable design 4).

The camera ranks frames while the network uploads — concurrently. A
frame becomes *available* for upload only after its ranking completes
(causality), and later passes may re-score unsent frames (lazy
invalidation: superseded heap entries are skipped at pop time, so the
queue reflects the newest ranking without a rebuild — the "continuously
reordering unsent frames" of Fig. 7).

Every rank carries a per-frame *generation*; an entry is live iff its
generation is the frame's newest. (Matching on score alone would let a
dead entry resurrect when a later pass re-ranks the frame to the exact
same score — saturated operator scores of 0.0/1.0 repeat across passes
— making the frame poppable before its newest ranking completes.)

Lazy invalidation alone lets the heap grow without bound across
re-ranking passes: every pass adds one entry per unsent frame, and the
superseded entries stay until popped. ``pop_best`` therefore compacts
the heap (dropping dead entries; generations make deadness permanent,
so this provably never reorders pops) whenever the stale fraction
exceeds ``COMPACT_STALE_FRACTION`` — an O(live) rebuild amortized
against the O(stale) pops it saves. Pop order is property-tested
against a compaction-free reference in ``tests/test_zc2_units.py``.
"""
from __future__ import annotations

import heapq
from collections import deque
from typing import Deque, Dict, List, Optional, Set, Tuple

COMPACT_STALE_FRACTION = 0.5   # rebuild when > half the heap is stale
COMPACT_MIN_HEAP = 64          # never bother below this size


class AsyncUploadQueue:
    def __init__(self, *, compact: bool = True,
                 compact_min_heap: int = COMPACT_MIN_HEAP,
                 compact_stale_fraction: float = COMPACT_STALE_FRACTION):
        self._pending: Deque[Tuple[float, float, int, int]] = deque()
        self._heap: List[Tuple[float, int, int]] = []
        self._score: Dict[int, float] = {}
        self._gen: Dict[int, int] = {}       # idx -> newest generation
        self._uploaded: Set[int] = set()
        self._compact_enabled = compact
        self._compact_min_heap = compact_min_heap
        self._compact_stale_fraction = compact_stale_fraction
        self._n_score_uploaded = 0   # |{idx in _score} ∩ _uploaded|
        self.compactions = 0

    def rank(self, t: float, idx: int, score: float) -> None:
        """Camera finished ranking ``idx`` at time ``t``."""
        if idx not in self._score and idx in self._uploaded:
            self._n_score_uploaded += 1
        g = self._gen.get(idx, 0) + 1
        self._gen[idx] = g
        self._score[idx] = score
        self._pending.append((t, score, idx, g))

    def mark_uploaded(self, idx: int) -> None:
        if idx not in self._uploaded and idx in self._score:
            self._n_score_uploaded += 1
        self._uploaded.add(idx)

    def uploaded(self, idx: int) -> bool:
        return idx in self._uploaded

    @property
    def n_uploaded(self) -> int:
        return len(self._uploaded)

    def current_score(self, idx: int, default: float = 0.5) -> float:
        return self._score.get(idx, default)

    @property
    def n_live(self) -> int:
        """Frames ranked at least once and not yet uploaded — an upper
        bound on the non-stale entries in ``_pending + _heap``."""
        return len(self._score) - self._n_score_uploaded

    def _admit(self, t: float) -> None:
        while self._pending and self._pending[0][0] <= t:
            _, score, idx, g = self._pending.popleft()
            heapq.heappush(self._heap, (-score, idx, g))

    def _dead(self, s: float, idx: int, g: int) -> bool:
        return idx in self._uploaded or self._gen.get(idx) != g

    def _maybe_compact(self) -> None:
        heap = self._heap
        if len(heap) < self._compact_min_heap or self.n_live >= \
                (1.0 - self._compact_stale_fraction) * len(heap):
            return
        # generations make deadness permanent, so dropping dead entries
        # now is indistinguishable from skipping them lazily at pop
        # time; heap order among survivors is preserved by heapify
        fresh = [e for e in heap if not self._dead(*e)]
        heapq.heapify(fresh)
        self._heap = fresh
        self.compactions += 1

    def pop_best(self, t: float) -> Tuple[Optional[int], Optional[float]]:
        """Best available frame at time ``t``.

        Returns (idx, None) when one is available; (None, t_next) when
        the queue is momentarily empty but a ranking completes at
        t_next; (None, None) when fully drained."""
        self._admit(t)
        if self._compact_enabled:
            self._maybe_compact()
        while self._heap:
            s, idx, g = heapq.heappop(self._heap)
            if self._dead(s, idx, g):
                continue
            return idx, None
        if self._pending:
            return None, self._pending[0][0]
        return None, None
