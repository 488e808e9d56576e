"""Sparse-but-sure landmarks (§4).

At capture time the camera runs the most accurate detector its hardware
sustains, at a long regular interval (1-in-30 frames by default). The
landmark store holds, per sampled frame: detections (labels + boxes)
and a low-res thumbnail reference (frames are re-renderable on demand,
so only indices are stored).

On query, the cloud pulls all landmarks in the queried range (cost =
thumbnail upload, simulated by the executor) and derives:
  * per-class spatial heatmaps -> operator input-crop regions (skew.py)
  * per-class temporal densities -> span prioritization
  * initial operator training sets (landmark frames + labels)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import oracle
from repro_torch.core.hardware import DetectorModel
from repro_torch.core.video import FRAME_H, FRAME_W, Video


@dataclass
class Landmark:
    idx: int
    detections: List[Tuple[str, float, float, float, float]]

    def present(self, cls: str) -> bool:
        return any(d[0] == cls for d in self.detections)

    def count(self, cls: str) -> int:
        return sum(1 for d in self.detections if d[0] == cls)


@dataclass
class LandmarkStore:
    video_name: str
    interval: int
    detector: str
    landmarks: List[Landmark] = field(default_factory=list)

    @property
    def indices(self) -> np.ndarray:
        return np.array([lm.idx for lm in self.landmarks], np.int64)

    def in_range(self, t0: int, t1: int) -> List[Landmark]:
        return [lm for lm in self.landmarks if t0 <= lm.idx < t1]


def build_landmarks(video: Video, interval: int,
                    det: DetectorModel) -> LandmarkStore:
    """Capture-time landmarking: regular sampling (unbiased, §4.2)."""
    store = LandmarkStore(video.spec.name, interval, det.name)
    for idx in range(0, video.spec.num_frames, interval):
        store.landmarks.append(Landmark(idx, oracle.detect(video, idx, det)))
    return store


def heatmap(store: LandmarkStore, cls: str) -> np.ndarray:
    """(H, W) object-occurrence density from landmark boxes (Fig. 4)."""
    h = np.zeros((FRAME_H, FRAME_W), np.float64)
    for lm in store.landmarks:
        for (c, y0, x0, y1, x1) in lm.detections:
            if c != cls:
                continue
            iy0, ix0 = max(0, int(y0)), max(0, int(x0))
            iy1, ix1 = min(FRAME_H, int(np.ceil(y1))), min(FRAME_W, int(np.ceil(x1)))
            if iy1 > iy0 and ix1 > ix0:
                h[iy0:iy1, ix0:ix1] += 1.0
    return h


def temporal_density(store: LandmarkStore, cls: str, num_frames: int,
                     grain_frames: int) -> np.ndarray:
    """Per-grain positive density estimate (long-term temporal skew)."""
    n_grains = -(-num_frames // grain_frames)
    pos = np.zeros(n_grains)
    tot = np.zeros(n_grains) + 1e-9
    for lm in store.landmarks:
        g = min(lm.idx // grain_frames, n_grains - 1)
        tot[g] += 1
        pos[g] += 1.0 if lm.present(cls) else 0.0
    return pos / tot


def positive_ratio(store: LandmarkStore, cls: str) -> float:
    """R_pos estimate used by the initial-operator rule (§6.1)."""
    if not store.landmarks:
        return 0.5
    return float(np.mean([lm.present(cls) for lm in store.landmarks]))


def count_stats(store: LandmarkStore, cls: str) -> dict:
    counts = np.array([lm.count(cls) for lm in store.landmarks],
                      np.float64)
    if len(counts) == 0:
        return {"mean": 0.0, "median": 0.0, "max": 0.0}
    return {"mean": float(counts.mean()), "median": float(np.median(counts)),
            "max": float(counts.max())}


def training_set(store: LandmarkStore, cls: str,
                 limit: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(frame_idxs, labels, counts) for operator bootstrapping (§4)."""
    lms = store.landmarks if limit is None else store.landmarks[:limit]
    idxs = np.array([lm.idx for lm in lms], np.int64)
    labels = np.array([lm.present(cls) for lm in lms], np.float32)
    counts = np.array([lm.count(cls) for lm in lms], np.float32)
    return idxs, labels, counts
