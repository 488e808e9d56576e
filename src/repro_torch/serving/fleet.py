"""FleetService — the cloud-side query front end over a camera fleet.

``serving/engine.py`` is the zoo-model side of the cloud (continuous
batching over decode slots); this module is the ZC² query side: many
users submit queries (T, C, kind) against registered cameras, one
``FleetScheduler`` drives them concurrently with cross-query batched
scoring and shared-uplink contention, and each user's inexact answer
streams back as it refines.

    svc = FleetService()
    svc.register_camera("jackson", video, store)
    qid = svc.submit("jackson", Query("retrieval", "car"))
    results = svc.run(on_progress=lambda qid, t, v: ...)
    svc.progress(qid)       # live Progress, also valid mid-run

Envs are built lazily at submit time (per-camera FrameBank shared
across that camera's queries, like a real cloud caching decoded frames
once per camera stream).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.core import landmarks as lm_mod
from repro_torch.core.fleet import FleetScheduler, make_executor
from repro_torch.core.query import Progress, Query, make_env
from repro_torch.core.training import FrameBank
from repro_torch.core.video import Video


class FleetService:
    """Register cameras, accept query submissions, run the fleet."""

    def __init__(self, *, contended: bool = True,
                 cloud_ingress_bytes_per_s: Optional[float] = None,
                 group_max: Optional[int] = None,
                 full_family: bool = False,
                 train_steps: int = 150, mesh=None, oracle=None):
        self.contended = contended
        self.cloud_ingress = cloud_ingress_bytes_per_s
        # None defers to the scheduler's device-aware default; see
        # core/fleet.device_aware_group_max
        self.group_max = group_max
        # shared verification front end (see core/fleet.FleetScheduler:
        # an OracleService, None for the default, False for inline)
        self.oracle = oracle
        self.mesh = mesh
        self.full_family = full_family
        self.train_steps = train_steps
        self._cameras: Dict[str, Tuple[Video, lm_mod.LandmarkStore,
                                       FrameBank]] = {}
        self._n_submitted = 0
        self._submissions: List[Tuple[str, str, object, dict]] = []
        self._progress: Dict[str, Progress] = {}
        self._results: Dict[str, Progress] = {}
        self.scheduler: Optional[FleetScheduler] = None

    # -- fleet membership -----------------------------------------------------

    def register_camera(self, name: str, video: Video,
                        store: lm_mod.LandmarkStore) -> None:
        """One zero-streaming camera: its (simulated) stream + the
        landmarks it has been trickling to the cloud."""
        self._cameras[name] = (video, store, FrameBank(video))

    @property
    def cameras(self) -> List[str]:
        return list(self._cameras)

    # -- query intake ---------------------------------------------------------

    def submit(self, camera: str, query: Query, *, net=None,
               qid: Optional[str] = None, priority: int = 0,
               weight: float = 1.0, slo_s: Optional[float] = None,
               **step_kwargs) -> str:
        """Queue a query against ``camera``; returns its qid.
        ``step_kwargs`` (``max_passes``, ``levels``, …) pass to the
        executor's stepper. The query's (initially empty) ``Progress``
        is available from ``progress(qid)`` immediately.
        ``priority``/``weight``/``slo_s`` are the query's verification
        admission parameters (see ``FleetScheduler.add``)."""
        if camera not in self._cameras:
            raise KeyError(f"unknown camera: {camera!r}")
        qid = qid or f"q{self._n_submitted}-{camera}-{query.kind}"
        if qid in self._progress:
            raise ValueError(f"duplicate qid: {qid!r}")
        video, store, bank = self._cameras[camera]
        env = make_env(video, query, store, net=net, bank=bank,
                       train_steps=self.train_steps)
        executor = make_executor(env, full_family=self.full_family)
        self._n_submitted += 1
        self._progress[qid] = Progress()
        step_kwargs.update(priority=priority, weight=weight, slo_s=slo_s)
        self._submissions.append((qid, camera, executor, step_kwargs))
        return qid

    # -- execution ------------------------------------------------------------

    def run(self, on_progress: Optional[Callable[[str, float, float],
                                                 None]] = None
            ) -> Dict[str, Progress]:
        """Drive all pending submissions to completion; returns
        ``{qid: Progress}`` and retains them for ``progress()``."""
        sched = FleetScheduler(
            contended=self.contended,
            cloud_ingress_bytes_per_s=self.cloud_ingress,
            group_max=self.group_max, mesh=self.mesh,
            oracle=self.oracle, on_progress=on_progress)
        for qid, camera, executor, kw in self._submissions:
            sched.add(qid, camera, executor, prog=self._progress[qid],
                      **kw)
        self._submissions.clear()
        self.scheduler = sched
        results = sched.run()
        self._results.update(results)
        return results

    def progress(self, qid: str) -> Progress:
        """The query's streaming Progress (mid-run object; final after
        ``run`` returns)."""
        return self._progress[qid]

    def result(self, qid: str) -> Progress:
        return self._results[qid]
