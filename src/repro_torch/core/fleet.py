"""FleetScheduler — N concurrent queries over M zero-streaming cameras.

The paper's setting is a cloud serving *fleets* of cameras, but each
executor is a single-query discrete-event loop. The stepper protocol
(``core/stepper``) makes those loops resumable; this module interleaves
many of them:

  * **Cross-query superbatched scoring with score/uplink overlap.**
    The moment a query blocks on a ``ScoreDemand`` its chunks go to a
    ``ScoreBatcher`` (``core/runtime``), which issues one stacked
    ``(group, bucket, …)`` dispatch per ``group_max`` same-(signature,
    bucket) chunks — eagerly, while the host loop keeps serving other
    queries' uplink ticks, so device compute overlaps the simulated
    uplink (PyTorch's launches are asynchronous, and the runtime copies
    each dispatch's input from page-locked host memory without
    waiting). Each stacked dispatch launches the grouped conv and
    scorer-head kernels once per layer for the whole group. The
    scheduler additionally drives
    the *bucket-complete* watermark: it tracks every unblocked query's
    last-known arch signature and tells the batcher which queues can no
    longer grow, so mixed-arch fleets (whose per-signature fan-in never
    reaches ``group_max``) still issue before the barrier. Results stay
    on-device until the no-ticks-pending barrier, where blocked
    steppers resume in task order. Fewer, larger, shape-stable
    dispatches, identical event ordering; the realized overlap is measured (``stats
    ["overlap_host_s"]``) as host time spent serving the loop while
    dispatches were in flight.

  * **Device-parallel scoring.** ``FleetScheduler(mesh=...)`` scores
    through a fleet-private ``OperatorRuntime(mesh=mesh)``, which splits
    each stacked superbatch group-wise over the mesh's devices (as the
    JAX package shards it), every member's bits the single device's;
    ``group_max`` then defaults to a multiple of the device count
    (``device_aware_group_max``), so full groups split evenly.

  * **Shared cloud verification.** Each ``VerifyDemand`` is stamped
    with the query's identity and routed to a shared
    ``serving/oracle_service.OracleService`` (continuous slot batching
    + admission control).  The ticket may complete eagerly inside a
    full slot, but the demanding stepper only resumes when its demand
    is the earliest pending event — verifies order *before* ticks at
    equal simulated time, which is exactly where the historical inline
    ``env.cloud_verify`` call sat (immediately after the task's own
    upload tick, before any later tick) — so the host order every
    contention factor observes is unchanged and routed fleets stay
    bit-identical to inline ones (``tests/test_oracle_service.py``).
    ``oracle=False`` keeps the inline synchronous path as the bitwise
    reference.

  * **Shared-uplink contention.** Each ``UploadTick`` is answered with
    ``seconds * factor`` where ``factor`` is the number of queries
    active on that camera at the tick's *simulated* start time (fair
    sharing over simulated-time overlap, independent of host scheduling
    order) times an optional cloud-ingress stretch
    ``max(1, demand / ingress)`` — a fluid approximation. With
    ``contended=False`` (or one query per camera and no ingress cap)
    the factor is 1.0 and every query's clock — and therefore its
    ``Progress`` — is bit-identical to its standalone ``run()``.

  * **Progress streaming.** Each query's inexact ``Progress`` refines
    online; ``on_progress(qid, t, value)`` fires on every refinement via
    ``Progress.subscribe``.

Each query keeps its own env/trainer/RNG streams; only scoring dispatch
and the uplink are shared. Executors join the fleet by exposing
``steps(prog=..., **kw)`` — any stepper works, including ones with no
operator at all (``SampleCountExecutor`` yields only UploadTicks).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Set

from repro_torch.core.counting import MaxCountExecutor, SampleCountExecutor
from repro_torch.core.filtering import TaggingExecutor
from repro_torch.core.query import Progress, QueryEnv
from repro_torch.core.ranking import RetrievalExecutor
from repro_torch.core.runtime import (ArchSig, OperatorRuntime, ScoreBatcher,
                                ScoreHandle, arch_signature, get_runtime)
from repro_torch.core.stepper import ScoreDemand, UploadTick, VerifyDemand
from repro_torch.serving.oracle_service import OracleService, VerifyTicket

DEFAULT_GROUP_MAX = 8


def device_aware_group_max(mesh=None, base: int = DEFAULT_GROUP_MAX) -> int:
    """The fused-dispatch high-watermark for a mesh: ``base`` rounded up
    to a multiple of the device count, so full superbatch groups always
    split evenly over the data axis (a non-dividing group runs whole on
    one device: correct, but without the mesh's parallelism). With no
    mesh (or one device) this is just ``base``."""
    d = mesh.size if mesh is not None else 1
    return max(base, ((base + d - 1) // d) * d)


def make_executor(env: QueryEnv, *, full_family: bool = False, **kw):
    """The executor for ``env.query.kind`` (the fleet's entry point for
    mixed workloads; kind-specific kwargs pass through)."""
    kind = env.query.kind
    if kind == "retrieval":
        return RetrievalExecutor(env, full_family=full_family, **kw)
    if kind == "tagging":
        return TaggingExecutor(env, full_family=full_family, **kw)
    if kind == "count_max":
        return MaxCountExecutor(env, full_family=full_family, **kw)
    if kind in ("count_avg", "count_mean"):
        return SampleCountExecutor(env, stat="mean", **kw)
    if kind == "count_median":
        return SampleCountExecutor(env, stat="median", **kw)
    raise ValueError(f"unknown query kind: {kind!r}")


@dataclass
class _Task:
    qid: str
    camera: str
    executor: object
    env: QueryEnv
    prog: Progress
    order: int = 0                # submission index (deterministic ties)
    priority: int = 0             # OracleService admission class
    weight: float = 1.0           # OracleService fair-share weight
    slo_s: Optional[float] = None  # OracleService queueing-delay budget
    gen: object = None            # the stepper
    tick: Optional[UploadTick] = None      # pending, not yet answered
    demand: Optional[ScoreDemand] = None   # pending, not yet answered
    vdemand: Optional[VerifyDemand] = None  # pending, not yet answered
    vticket: Optional[VerifyTicket] = None  # in-flight service ticket
    handle: Optional[ScoreHandle] = None   # in-flight device results
    result: Optional[Progress] = None
    ticks: int = 0
    verifies: int = 0
    sig: Optional[ArchSig] = None  # last demand's arch signature
    pot: bool = False              # counted as a potential contributor
    pot_key: Optional[ArchSig] = None      # key it is counted under

    @property
    def finished(self) -> bool:
        return self.result is not None

    @property
    def scoring(self) -> bool:
        """May this executor ever yield a ScoreDemand?  Operator-free
        kinds (``SampleCountExecutor``) declare ``demands_scoring =
        False`` so they never hold the bucket-complete watermark open
        as unknown-signature contributors."""
        return getattr(self.executor, "demands_scoring", True)


class FleetScheduler:
    """Interleave many query steppers; batch their scoring; share the
    uplink. ``run()`` returns ``{qid: Progress}``.

    ``contended``     model shared per-camera uplink + cloud ingress;
                      ``False`` reproduces standalone clocks exactly.
    ``cloud_ingress_bytes_per_s``
                      aggregate cloud ingress cap (None = unbounded).
    ``group_max``     max demands fused into one runtime dispatch
                      (default: ``device_aware_group_max(mesh)``).
    ``mesh``          a scoring mesh (``launch/mesh.make_scoring_mesh``)
                      to split superbatches over; None scores on one
                      device.
    ``on_progress``   ``fn(qid, t, value)`` streamed per refinement.
    ``oracle``        the shared verification service: an
                      ``OracleService`` instance, ``None`` for a
                      default (cached-answer) one, or ``False`` to
                      answer every ``VerifyDemand`` inline and
                      synchronously — the historical single-query path,
                      kept as the bitwise reference for the routed one.
    ``runtime``       OperatorRuntime override (default: the
                      process-global one, shared by the whole fleet;
                      with ``mesh``, a fleet-private mesh runtime).
    """

    def __init__(self, *, runtime: Optional[OperatorRuntime] = None,
                 contended: bool = True,
                 cloud_ingress_bytes_per_s: Optional[float] = None,
                 group_max: Optional[int] = None,
                 mesh=None,
                 oracle=None,
                 on_progress: Optional[Callable[[str, float, float],
                                               None]] = None):
        self._runtime = runtime
        self.oracle: Optional[OracleService] = \
            None if oracle is False else \
            (oracle if oracle is not None else OracleService())
        self.mesh = mesh
        self.contended = contended
        self.cloud_ingress = cloud_ingress_bytes_per_s
        self.group_max = (group_max if group_max is not None
                          else device_aware_group_max(mesh))
        self.on_progress = on_progress
        self.tasks: List[_Task] = []
        self.stats: Dict[str, object] = {}
        # potential-contributor census for the bucket-complete
        # watermark: key = last-known arch signature (None = a scoring
        # task that has not demanded yet, so its signature is unknown)
        self._pot: Dict[Optional[ArchSig], int] = {}

    @property
    def runtime(self) -> OperatorRuntime:
        if self._runtime is None and self.mesh is not None:
            self._runtime = OperatorRuntime(mesh=self.mesh)
        return self._runtime if self._runtime is not None else get_runtime()

    # -- fleet assembly -------------------------------------------------------

    def add(self, qid: str, camera: str, executor,
            prog: Optional[Progress] = None, *, priority: int = 0,
            weight: float = 1.0, slo_s: Optional[float] = None,
            **step_kwargs) -> str:
        """Enroll a query: ``executor`` must expose ``steps(prog=...)``;
        extra kwargs (``max_passes`` etc.) pass through to it. A caller
        holding a ``prog`` (e.g. FleetService handing it out at submit
        time) may pass it in; otherwise one is created.

        ``priority``/``weight``/``slo_s`` are the query's
        ``OracleService`` admission parameters (verification urgency
        class, fair-share weight, queueing-delay budget in simulated
        seconds). They shape the service's slot admission only — never
        the query's own clock — so they are free to vary without
        perturbing results."""
        if any(t.qid == qid for t in self.tasks):
            raise ValueError(f"duplicate qid: {qid!r}")
        prog = prog if prog is not None else Progress()
        if self.on_progress is not None:
            prog.subscribe(
                lambda t, v, qid=qid: self.on_progress(qid, t, v))
        task = _Task(qid, camera, executor, executor.env, prog,
                     order=len(self.tasks), priority=priority,
                     weight=weight, slo_s=slo_s)
        task.gen = executor.steps(prog=prog, **step_kwargs)
        if self.oracle is not None:
            self.oracle.register(qid, executor.env, priority=priority,
                                 weight=weight, slo_s=slo_s)
        self.tasks.append(task)
        return qid

    # -- contention model -----------------------------------------------------

    def _active_at(self, other: _Task, at: float) -> bool:
        """Is ``other`` still uploading at simulated time ``at``?  Every
        query starts at simulated time 0; a finished one stops at its
        ``done_t``; an unfinished one is treated as active.  That last
        clause is the model's conservative edge: while a peer is parked
        at a score barrier, ticks past its *eventual* completion still
        count it as a sharer (its end time is unknowable without
        serving the score round, and serving rounds early would shrink
        cross-query batches).  The estimate is a deterministic function
        of global state, so results stay independent of submission
        order; it only errs toward more contention."""
        if not other.finished:
            return True
        end = other.result.done_t
        return end is not None and end > at

    def _uplink_factor(self, task: _Task, at: float) -> float:
        """Fluid contention for a transfer starting at simulated time
        ``at``: the camera's uplink is shared fairly by its queries
        active at ``at`` (simulated-time overlap, not host scheduling
        order), and the cloud ingress (if capped) stretches every
        transfer by the oversubscription ratio."""
        if not self.contended:
            return 1.0
        sharers = sum(1 for t in self.tasks
                      if t.camera == task.camera and
                      (t is task or self._active_at(t, at)))
        factor = float(max(sharers, 1))
        if self.cloud_ingress:
            # each active camera demands its uplink rate; if its queries
            # carry different NetworkModels, take the fastest (one
            # physical link per camera; max is order-independent)
            per_cam: Dict[str, float] = {}
            for t in self.tasks:
                if t is task or self._active_at(t, at):
                    per_cam[t.camera] = max(
                        per_cam.get(t.camera, 0.0),
                        t.env.net.uplink_bytes_per_s)
            factor *= max(1.0, sum(per_cam.values()) / self.cloud_ingress)
        return factor

    # -- scheduling loop ------------------------------------------------------

    def _step(self, task: _Task, resp) -> None:
        """Resume one stepper by one work item; park the item on the
        task (``tick``/``demand``/``vdemand``) or record its final
        Progress.  VerifyDemands are stamped with the task's fleet
        identity; with a shared ``OracleService`` the demand parks and
        its ticket enters the service (eager slot batching), without
        one it is answered inline and synchronously — the historical
        single-query path."""
        task.tick = task.demand = task.vdemand = None
        while True:
            try:
                item = task.gen.send(resp)
            except StopIteration as e:
                task.result = e.value
                return
            if isinstance(item, UploadTick):
                task.tick = item
                return
            if isinstance(item, ScoreDemand):
                task.demand = item
                return
            if isinstance(item, VerifyDemand):
                item.qid, item.priority = task.qid, task.priority
                task.verifies += 1
                if self.oracle is None:
                    resp = task.env.cloud_verify(item.idx)
                    continue
                task.vdemand = item
                task.vticket = self.oracle.submit(item)
                return
            raise TypeError(f"unknown work item from {task.qid}: {item!r}")

    # -- bucket-complete watermark census -------------------------------------

    def _pot_add(self, task: _Task) -> None:
        """Count a scoring task as a potential contributor under its
        last-known signature (None until its first demand)."""
        if task.pot or not task.scoring:
            return
        key = task.sig
        self._pot[key] = self._pot.get(key, 0) + 1
        task.pot, task.pot_key = True, key

    def _pot_remove(self, task: _Task) -> None:
        if task.pot:
            self._pot[task.pot_key] -= 1
            task.pot = False

    def _possible_sigs(self) -> Optional[Set[ArchSig]]:
        """Signatures that may still gain queued chunks before the next
        flush. ``None`` (wildcard) while any scoring task's signature
        is unknown — nothing can be ruled out then."""
        if self._pot.get(None, 0) > 0:
            return None
        return {k for k, v in self._pot.items() if v > 0 and k is not None}

    def _advance(self, task: _Task, resp, batcher: ScoreBatcher) -> None:
        """Resume one stepper and, if it blocks on a ScoreDemand, submit
        the demand to the batcher *immediately*. The dispatch may go to
        the device right away (queue at ``group_max``) while the task
        stays parked until the barrier — eager issue, unchanged
        event ordering. Keeps the contributor census current: a task
        that just submitted (or finished) cannot add chunks until it is
        resumed again, so it leaves the census; a ticking task stays."""
        self._step(task, resp)
        if task.demand is not None:
            task.sig = arch_signature(task.demand.trained.arch)
            self._pot_remove(task)
            task.handle = batcher.submit(
                task.demand.trained, task.env.bank, task.demand.idxs)
        elif task.finished:
            self._pot_remove(task)

    def run(self) -> Dict[str, Progress]:
        """Drive every query to completion: UploadTicks are answered one
        at a time in global *simulated-time* order (so the contention
        factor sees the same overlaps regardless of submission order).

        Scoring overlaps the uplink loop: the moment a stepper blocks on
        a ``ScoreDemand`` its chunks are submitted to a ``ScoreBatcher``,
        which issues a fused superbatch dispatch whenever ``group_max``
        same-(signature, bucket) chunks have accumulated — so the device
        computes (asynchronous launches) while the host keeps serving
        simulated uplink ticks for the other queries. When no transfers
        are in flight, the remaining partial groups flush and every
        blocked stepper resumes — in task order, with results pulled
        from its on-device handle. Resumption points and ordering are
        exactly the pre-overlap barrier rounds', and every dispatch
        layout is bit-identical to single-demand scoring, so fleet runs
        stay bit-equivalent to standalone ones."""
        if not self.tasks:
            return {}
        rt = self.runtime
        calls0, frames0 = rt.calls, rt.frames_scored
        batcher = ScoreBatcher(rt, group_max=self.group_max)
        rounds = 0
        # real host-time accounting (never feeds the simulated clocks):
        # overlap_host_s integrates host work done while score
        # dispatches were in flight on the device; result_block_s is
        # time spent waiting on device results at the barrier. These
        # stats are the only wall-clock reads here, each waived inline
        # (DET001), as the JAX package's waiver file does for its copy.
        overlap_s = 0.0
        block_s = 0.0
        for task in self.tasks:
            self._pot_add(task)
        for task in self.tasks:
            self._advance(task, None, batcher)
            batcher.fire_complete(self._possible_sigs())
        def event_key(t: _Task):
            # earliest simulated event first; a verification orders
            # *before* a transfer at the same instant — the inline call
            # it replaces ran within the serving of the tick that
            # produced it, i.e. before any tick at (or after) the
            # verify's own simulated time, and a finished query's
            # ``done_t == at`` tie in ``_active_at`` observes the
            # difference
            if t.vdemand is not None:
                return (t.vdemand.at, 0, t.order)
            return (t.tick.at, 1, t.order)

        while True:
            # earliest pending transfer/verification across the fleet
            # first (global simulated-time order)
            events = [t for t in self.tasks
                      if t.tick is not None or t.vdemand is not None]
            if events:
                task = min(events, key=event_key)
                t0 = time.perf_counter() if batcher.in_flight else None  # noqa: DET001
                if task.vdemand is not None:
                    # the demand's simulated position is due: force its
                    # slot through the service (it may already have
                    # completed eagerly inside a full slot) and resume
                    ticket, task.vticket = task.vticket, None
                    self._advance(task, self.oracle.complete(ticket),
                                  batcher)
                else:
                    item = task.tick
                    task.ticks += 1
                    self._advance(task, item.seconds *
                                  self._uplink_factor(task, item.at),
                                  batcher)
                batcher.fire_complete(self._possible_sigs())
                if t0 is not None:
                    overlap_s += time.perf_counter() - t0  # noqa: DET001
                continue
            # no transfers or verifications in flight (the no-ticks-
            # pending watermark): flush partial groups, then resume
            # every score-blocked stepper in task order from its
            # on-device results
            blocked = [t for t in self.tasks if t.demand is not None]
            if not blocked:
                break
            rounds += 1
            batcher.flush()
            # every blocked task is about to be resumed and may submit
            # again — back into the census (under its current
            # signature) until its resumption decides otherwise
            for task in blocked:
                self._pot_add(task)
            for task in blocked:
                handle, task.handle = task.handle, None
                t0 = time.perf_counter()  # noqa: DET001
                resp = handle.result()
                block_s += time.perf_counter() - t0  # noqa: DET001
                t0 = time.perf_counter() if batcher.in_flight else None  # noqa: DET001
                self._advance(task, resp, batcher)
                batcher.fire_complete(self._possible_sigs())
                if t0 is not None:
                    overlap_s += time.perf_counter() - t0  # noqa: DET001
        self.stats = {
            "queries": len(self.tasks),
            "cameras": len({t.camera for t in self.tasks}),
            "score_rounds": rounds,
            "dispatches": rt.calls - calls0,
            "eager_dispatches": batcher.eager_dispatches,
            "watermark_fires": dict(batcher.watermark_fires),
            "frames_scored": rt.frames_scored - frames0,
            "upload_ticks": sum(t.ticks for t in self.tasks),
            "verify_demands": sum(t.verifies for t in self.tasks),
            "overlap_host_s": round(overlap_s, 4),
            "result_block_s": round(block_s, 4),
            "oracle": self.oracle.stats() if self.oracle is not None
            else None,
            **rt.mesh_info(),
        }
        return {t.qid: t.result for t in self.tasks}
