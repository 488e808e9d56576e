"""Query model, execution environment, and progress accounting (§3).

A query (T, C) covers a frame range and an object class, with a type in
{retrieval, tagging, count_max, count_avg, count_median}. Ground truth
is the *cloud detector's* (YOLOv3-tier oracle) output over the range —
exactly the paper's definition — so execution and evaluation agree.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import landmarks as lm_mod
from repro_torch.core import oracle
from repro_torch.core.hardware import (CameraTier, CloudModel, DetectorModel,
                                 NetworkModel, RPI3, YOLO_V3)
from repro_torch.core.training import CloudTrainer, FrameBank
from repro_torch.core.video import Video


@dataclass(frozen=True)
class Query:
    kind: str                 # retrieval | tagging | count_max | count_avg | count_median
    cls: str
    t0: int = 0               # frame range [t0, t1)
    t1: Optional[int] = None
    error_budget: float = 0.01


@dataclass
class Progress:
    """Time series of user-visible query progress + network accounting.

    ``subscribe`` registers streaming listeners: every refinement of the
    (inexact) answer is pushed to them as it is recorded, which is how
    the ``FleetScheduler``/``FleetService`` stream per-query progress to
    users while many queries are in flight.  Listeners are bookkeeping,
    not state: they are excluded from equality, so a streamed Progress
    still compares bit-identical to an unstreamed one.
    """
    points: List[Tuple[float, float]] = field(default_factory=list)
    bytes_up: float = 0.0
    op_switches: List[Tuple[float, str]] = field(default_factory=list)
    done_t: Optional[float] = None
    _listeners: List = field(default_factory=list, repr=False, compare=False)

    def subscribe(self, fn) -> None:
        """``fn(t, value)`` is called on every recorded refinement."""
        self._listeners.append(fn)

    def record(self, t: float, value: float) -> None:
        if not self.points or value != self.points[-1][1]:
            self.points.append((t, value))
            for fn in self._listeners:
                fn(t, value)

    def time_to(self, frac: float) -> Optional[float]:
        for t, v in self.points:
            if v >= frac - 1e-12:
                return t
        return None

    def value_at(self, t: float) -> float:
        out = 0.0
        for tt, v in self.points:
            if tt <= t:
                out = v
            else:
                break
        return out


@dataclass
class QueryEnv:
    """Everything one query execution touches."""
    video: Video
    query: Query
    store: lm_mod.LandmarkStore
    bank: FrameBank
    trainer: CloudTrainer
    net: NetworkModel
    tier: CameraTier
    cloud: CloudModel
    cloud_det: DetectorModel
    gt_positive: np.ndarray       # per-frame, cloud-detector ground truth
    gt_count: np.ndarray

    @property
    def frames(self) -> np.ndarray:
        t1 = self.query.t1 if self.query.t1 is not None else self.video.spec.num_frames
        return np.arange(self.query.t0, t1, dtype=np.int64)

    @property
    def n_frames(self) -> int:
        return len(self.frames)

    @property
    def n_positives(self) -> int:
        return int(self.gt_positive.sum())

    def cloud_verify(self, idx: int) -> Tuple[bool, int]:
        """Cloud-side detection on an uploaded frame (authoritative)."""
        i = int(idx) - self.query.t0
        return bool(self.gt_positive[i]), int(self.gt_count[i])

    def is_positive(self, idx: int) -> bool:
        return bool(self.gt_positive[int(idx) - self.query.t0])


def make_env(video: Video, query: Query, store: lm_mod.LandmarkStore,
             *, net: Optional[NetworkModel] = None,
             tier: CameraTier = RPI3,
             cloud: Optional[CloudModel] = None,
             cloud_det: DetectorModel = YOLO_V3,
             bank: Optional[FrameBank] = None,
             train_steps: int = 150, seed: int = 0) -> QueryEnv:
    net = net or NetworkModel()
    cloud = cloud or CloudModel()
    bank = bank or FrameBank(video)
    t1 = query.t1 if query.t1 is not None else video.spec.num_frames
    idxs = np.arange(query.t0, t1)
    gt_pos = oracle.present_vec(video, idxs, query.cls, cloud_det)
    gt_cnt = oracle.count_vec(video, idxs, query.cls, cloud_det)
    trainer = CloudTrainer(bank, query.cls, cloud,
                           error_budget=query.error_budget, seed=seed,
                           train_steps=train_steps)
    return QueryEnv(video, query, store, bank, trainer, net, tier, cloud,
                    cloud_det, gt_pos, gt_cnt)
