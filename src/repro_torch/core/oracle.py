"""Detector oracle with accuracy tiers (YOLOv3 / YOLOv2 / YOLOv3-tiny).

The oracle corrupts synthetic ground truth deterministically per
(video, frame, detector): misses grow as objects shrink and accuracy
drops; false positives appear at a tier-dependent rate. Query ground
truth is defined — exactly as in the paper (§8.2) — as the *cloud
YOLOv3* output, i.e. the yolov3-tier oracle, so "positives" and counts
are consistent between execution and evaluation.

``score`` exposes a continuous per-frame confidence used by the
PreIndexAll baseline (index confidences) and for threshold calibration.
"""
from __future__ import annotations

import zlib
from typing import List, Tuple

import numpy as np

from repro_torch.core.hardware import DetectorModel
from repro_torch.core.video import FRAME_H, FRAME_W, Video


def _rng_for(video: Video, idx: int, det: DetectorModel):
    # process-stable hash (python's hash() is salted per process)
    key = f"{video.spec.seed}|{int(idx)}|{det.name}".encode()
    return np.random.default_rng(zlib.crc32(key) & 0x7FFFFFFF)


def _detect_prob(det: DetectorModel, size_px: float) -> float:
    """Larger objects are easier; worse detectors degrade faster on
    small ones (the dominant accuracy effect in surveillance video)."""
    size_factor = np.clip((size_px - 4.0) / 24.0, 0.05, 1.0) ** 0.5
    return float(np.clip(det.accuracy * (0.55 + 0.45 * size_factor), 0, 1))


def detect(video: Video, idx: int, det: DetectorModel
           ) -> List[Tuple[str, float, float, float, float]]:
    """Detections [(cls, y0, x0, y1, x1)] for frame idx under ``det``."""
    rng = _rng_for(video, idx, det)
    out = []
    for (cls, y0, x0, y1, x1) in video.gt_boxes(idx):
        size = max(y1 - y0, x1 - x0)
        if rng.uniform() < _detect_prob(det, size):
            jitter = (1.0 - det.accuracy) * size * 0.3
            dy, dx = rng.normal(0, jitter, 2)
            out.append((cls, y0 + dy, x0 + dx, y1 + dy, x1 + dx))
    # false positives: rate grows as accuracy falls
    fp_rate = (1.0 - det.accuracy) * 0.6
    n_fp = rng.poisson(fp_rate)
    classes = [c.name for c in video.spec.classes]
    for _ in range(n_fp):
        cls = classes[rng.integers(len(classes))]
        y, x = rng.uniform(0, FRAME_H), rng.uniform(0, FRAME_W)
        s = rng.uniform(6, 20)
        out.append((cls, y, x, min(FRAME_H, y + s), min(FRAME_W, x + s)))
    return out


def count(video: Video, idx: int, cls: str, det: DetectorModel) -> int:
    return sum(1 for d in detect(video, idx, det) if d[0] == cls)


def present(video: Video, idx: int, cls: str, det: DetectorModel) -> bool:
    return count(video, idx, cls, det) > 0


def score(video: Video, idx: int, cls: str, det: DetectorModel) -> float:
    """Continuous confidence in [0,1] that frame contains ``cls``.

    True positives score high minus tier noise; negatives score low plus
    tier noise — the index-confidence model for PreIndexAll."""
    rng = _rng_for(video, idx, det)
    rng.uniform()                      # decorrelate from detect() draws
    gt = video.gt_present(idx, cls)
    noise_sd = (1.0 - det.accuracy) * 0.45 + 0.05
    base = 0.82 if gt else 0.15
    boxes = video.gt_boxes(idx, cls)
    if gt and boxes:
        size = max(max(b[3] - b[1], b[4] - b[2]) for b in boxes)
        base *= 0.7 + 0.3 * min(size / 24.0, 1.0)
    return float(np.clip(rng.normal(base, noise_sd), 0.0, 1.0))


def present_vec(video: Video, idxs, cls: str, det: DetectorModel) -> np.ndarray:
    return np.array([present(video, int(i), cls, det) for i in idxs], bool)


def count_vec(video: Video, idxs, cls: str, det: DetectorModel) -> np.ndarray:
    return np.array([count(video, int(i), cls, det) for i in idxs], np.int32)


def score_vec(video: Video, idxs, cls: str, det: DetectorModel) -> np.ndarray:
    return np.array([score(video, int(i), cls, det) for i in idxs], np.float64)
