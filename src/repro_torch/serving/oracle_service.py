"""OracleService — shared cloud-side upload verification for a fleet.

DIVA's cloud verifies every uploaded frame with the expensive detector
(§6.1).  Pre-service, each executor called ``env.cloud_verify``
synchronously one frame at a time, so at high query counts the
expensive-operator path was the cloud's serial bottleneck.  This module
is the cloud's verification front end: all fleet queries'
``VerifyDemand`` work items (see ``core/stepper``) route here, and the
service batches them over **fixed verification slots** —
``ServeEngine``-style continuous batching: a slot holds up to
``slot_frames`` frames, fires eagerly the moment it fills, and new
demands stream into the next slot as earlier ones complete.

**Admission control** decides which pending demands fill a slot, in
deterministic order:

  1. *SLO deadlines* (simulated time): a demand whose per-query
     ``slo_s`` budget has expired relative to the service's simulated
     clock is overdue and preempts everything else.
  2. *Priority*: higher ``priority`` lanes are served first.
  3. *Weighted fair share*: within a priority class, lanes are ordered
     by weighted-fair-queueing virtual finish times — each lane's
     demands consume virtual time at ``1 / weight``, so one heavy
     retrieval query cannot starve counting queries regardless of how
     many demands it floods in (its later demands carry ever-larger
     virtual finish times while a light lane's stay near the virtual
     clock).

**Bit-equivalence.**  A verification answer is a pure, deterministic
function of ``(video, frame, class, detector)`` — ``oracle.detect`` is
seeded per ``(video, frame, detector)`` — so it is independent of slot
composition, admission order, and arrival order.  Batching therefore
changes *when* an answer materializes (service accounting, host
wall-clock) but never *what* it is; routed fleet runs stay bitwise
identical to the historical inline ``env.cloud_verify`` path
(``tests/test_oracle_service.py``).  Verification is instantaneous in
*query* simulated time, exactly as the inline call was — ``demand.at``
feeds the service's own queueing/SLO clock, never the stepper's.

**Vectorized verification.**  A slot resolves all of its frames in one
``_verify_slot`` pass: frames are deduplicated per
``(video, detector)`` — concurrent queries verifying the same frame
share one detector invocation — and each unique frame's detection set
answers every (class, query) pair that demanded it, presence and count
together.  ``compute="cached"`` (the fleet default) answers from the
env's precomputed ground-truth arrays; ``compute="detect"`` re-runs the
detector — both are bit-identical (the arrays were built by the same
oracle), the latter is what ``benchmarks/bench_oracle.py`` measures.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core import oracle
from repro_torch.core.stepper import VerifyDemand


@dataclass
class QueryLane:
    """Per-query admission state (one lane per registered qid)."""
    qid: str
    env: object
    priority: int = 0          # higher = served earlier
    weight: float = 1.0        # fair-share weight within a priority class
    slo_s: Optional[float] = None   # queueing-delay budget in simulated s
    vft: float = 0.0           # WFQ virtual finish time of the last demand
    served: int = 0
    delays: List[float] = field(default_factory=list)
    max_slots_waited: int = 0


class VerifyTicket:
    """One pending verification; resolves when its slot completes.

    Like ``ScoreHandle`` for scoring: the submitting scheduler parks the
    demanding stepper and resumes it from ``result()`` at the demand's
    simulated-time position — the service may have completed the ticket
    long before (eager slot fire) or may complete it on demand
    (``OracleService.complete``)."""

    __slots__ = ("demand", "lane", "seq", "vft", "submit_slot", "done",
                 "pos", "cnt", "finish_t")

    def __init__(self, demand: VerifyDemand, lane: QueryLane, seq: int,
                 vft: float, submit_slot: int):
        self.demand = demand
        self.lane = lane
        self.seq = seq
        self.vft = vft
        self.submit_slot = submit_slot
        self.done = False
        self.pos: bool = False
        self.cnt: int = 0
        self.finish_t: float = 0.0

    def result(self) -> Tuple[bool, int]:
        if not self.done:
            raise RuntimeError(
                f"ticket for frame {self.demand.idx} (qid="
                f"{self.demand.qid!r}) read before its slot completed; "
                "callers must call OracleService.complete(ticket) first")
        return self.pos, self.cnt


class OracleService:
    """Continuous-batched, admission-controlled upload verification.

    ``slot_frames``  fixed slot capacity (frames per detector batch).
    ``det_fps``      the cloud detector's per-frame rate, defining the
                     service's *simulated* timeline for queueing-delay
                     and SLO accounting (a slot of k frames takes
                     ``k / det_fps`` simulated seconds).  Purely
                     observational: query clocks never see it.
    ``compute``      ``"cached"`` answers from each env's precomputed
                     ground truth; ``"detect"`` re-runs the oracle
                     detector per unique frame (bit-identical; the
                     benchmark mode).
    ``eager``        fire a slot as soon as it fills (the continuous-
                     batching default); ``False`` only batches when
                     ``complete``/``flush`` force it (lets unit tests
                     stage a known pending set).
    """

    def __init__(self, *, slot_frames: int = 8, det_fps: float = 30.0,
                 compute: str = "cached", eager: bool = True):
        assert compute in ("cached", "detect")
        self.slot_frames = max(1, int(slot_frames))
        self.det_fps = det_fps
        self.compute = compute
        self.eager = eager
        self.lanes: Dict[str, QueryLane] = {}
        self.now = 0.0             # service-side simulated clock
        self._vclock = 0.0         # WFQ virtual clock
        self._seq = 0
        self._heap: List[tuple] = []       # (key, seq, ticket)
        self._overdue_bumped = 0
        # accounting
        self.slots_run = 0
        self.frames_verified = 0           # demands answered
        self.detect_calls = 0              # unique-frame detector runs
        self.dedup_hits = 0                # demands answered by a shared run
        self._occupancy: List[int] = []

    # -- lanes ---------------------------------------------------------------

    def register(self, qid: str, env, *, priority: int = 0,
                 weight: float = 1.0,
                 slo_s: Optional[float] = None) -> QueryLane:
        """Open a lane for ``qid``; idempotent (later calls update the
        admission parameters but keep the lane's fair-share state)."""
        lane = self.lanes.get(qid)
        if lane is None:
            lane = self.lanes[qid] = QueryLane(qid, env)
        lane.env = env if env is not None else lane.env
        lane.priority = priority
        lane.weight = max(weight, 1e-9)
        lane.slo_s = slo_s
        return lane

    # -- intake --------------------------------------------------------------

    def submit(self, demand: VerifyDemand, env=None) -> VerifyTicket:
        """Queue one demand; returns its ticket.  ``demand.qid`` must be
        stamped (the routing scheduler knows the query's identity; steppers
        do not).  An unregistered qid opens a default lane — ``env`` is
        required then (it is the answer source)."""
        qid = demand.qid if demand.qid is not None else "?"
        lane = self.lanes.get(qid)
        if lane is None:
            if env is None:
                raise ValueError(
                    f"qid {qid!r} not registered and no env given")
            lane = self.register(qid, env, priority=demand.priority)
        # WFQ: this demand finishes one weighted unit after the later of
        # the lane's previous finish and the current virtual clock
        lane.vft = max(self._vclock, lane.vft) + 1.0 / lane.weight
        ticket = VerifyTicket(demand, lane, self._seq, lane.vft,
                              self.slots_run)
        self._seq += 1
        heapq.heappush(self._heap, (self._key(ticket), ticket.seq, ticket))
        if self.eager:
            while self.pending >= self.slot_frames:
                self.step()
        return ticket

    def _key(self, t: VerifyTicket) -> tuple:
        """Admission order: overdue first, then priority (higher first),
        then WFQ virtual finish time, then arrival."""
        overdue = (t.lane.slo_s is not None and
                   self.now >= t.demand.at + t.lane.slo_s)
        return (0 if overdue else 1, -t.lane.priority, t.vft, t.seq)

    @property
    def pending(self) -> int:
        return len(self._heap)

    # -- slots ---------------------------------------------------------------

    def step(self) -> List[VerifyTicket]:
        """Run one verification slot: admit up to ``slot_frames``
        pending demands (admission order), verify them in one vectorized
        pass, advance the simulated clock, resolve their tickets."""
        if not self._heap:
            return []
        # overdue-ness depends on self.now, which moves between slots:
        # re-key the frontier so expired SLOs actually preempt
        self._rekey_overdue()
        batch: List[VerifyTicket] = []
        while self._heap and len(batch) < self.slot_frames:
            _, _, ticket = heapq.heappop(self._heap)
            batch.append(ticket)
        self._verify_slot(batch)
        self.slots_run += 1
        self._occupancy.append(len(batch))
        self._vclock = max(self._vclock, min(t.vft for t in batch))
        start = max(self.now, min(t.demand.at for t in batch))
        finish = start + len(batch) / self.det_fps
        self.now = finish
        for t in batch:
            t.done = True
            t.finish_t = finish
            t.lane.served += 1
            t.lane.delays.append(max(0.0, finish - t.demand.at))
            t.lane.max_slots_waited = max(
                t.lane.max_slots_waited, self.slots_run - t.submit_slot)
        self.frames_verified += len(batch)
        return batch

    def _rekey_overdue(self) -> None:
        """Rebuild heap keys when SLO expiry changed any ordering class
        (keys are computed against the moving simulated clock)."""
        if not any(lane.slo_s is not None for lane in self.lanes.values()):
            return
        fresh = [(self._key(t), t.seq, t) for _, _, t in self._heap]
        bumped = sum(1 for (k, _, _), (old, _, _2) in
                     zip(fresh, self._heap) if k[0] != old[0])
        if bumped:
            self._overdue_bumped += bumped
        heapq.heapify(fresh)
        self._heap = fresh

    def complete(self, ticket: VerifyTicket) -> Tuple[bool, int]:
        """Drive slots (admission order) until ``ticket`` resolves —
        the routing scheduler calls this when the demand's simulated-time
        position is reached and the answer is needed *now*."""
        while not ticket.done:
            self.step()
        return ticket.result()

    def flush(self) -> None:
        """Drain every pending demand (end-of-run barrier)."""
        while self._heap:
            self.step()

    # -- verification --------------------------------------------------------

    def _verify_slot(self, batch: List[VerifyTicket]) -> None:
        """Answer a slot in one pass.  Frames are deduplicated per
        (video, detector): every demand for the same physical frame
        shares one detector run, and that run answers each demand's own
        class (presence and count together)."""
        if self.compute == "cached":
            for t in batch:
                t.pos, t.cnt = t.lane.env.cloud_verify(int(t.demand.idx))
            return
        runs: Dict[tuple, list] = {}
        for t in batch:
            env = t.lane.env
            key = (env.video.spec.name, env.video.spec.seed,
                   env.cloud_det.name, int(t.demand.idx))
            if key in runs:
                self.dedup_hits += 1
            else:
                runs[key] = oracle.detect(env.video, int(t.demand.idx),
                                          env.cloud_det)
                self.detect_calls += 1
            cnt = sum(1 for d in runs[key] if d[0] == t.demand.cls)
            t.pos, t.cnt = cnt > 0, cnt
        del runs

    # -- reporting -----------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        occ = self._occupancy
        per_priority: Dict[int, List[float]] = {}
        for lane in self.lanes.values():
            per_priority.setdefault(lane.priority, []).extend(lane.delays)
        return {
            "frames_verified": self.frames_verified,
            "slots": self.slots_run,
            "slot_frames": self.slot_frames,
            "occupancy_mean": round(sum(occ) / len(occ), 2) if occ else 0.0,
            "occupancy_max": max(occ) if occ else 0,
            "detect_calls": self.detect_calls,
            "dedup_hits": self.dedup_hits,
            "overdue_bumped": self._overdue_bumped,
            "queue_delay_s": {
                p: {"n": len(ds),
                    "mean": round(sum(ds) / len(ds), 4) if ds else 0.0,
                    "max": round(max(ds), 4) if ds else 0.0}
                for p, ds in sorted(per_priority.items())},
            "per_qid": {
                lane.qid: {"served": lane.served,
                           "priority": lane.priority,
                           "weight": lane.weight,
                           "max_slots_waited": lane.max_slots_waited}
                for lane in self.lanes.values()},
        }
