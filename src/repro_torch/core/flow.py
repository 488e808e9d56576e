"""Optical-flow label amplification (§7 "Optimization with optical flow").

The camera tracks objects detected on landmark frames into adjacent
frames until they leave the view; tracked frames become extra labeled
training samples at a fraction of detection cost. We simulate tracking
fidelity (per-step success ~0.92, matching short-horizon KLT tracking on
static cameras) over the synthetic events: propagated labels can thus be
slightly wrong, exactly like real flow — the trainer sees that noise.
"""
from __future__ import annotations

import zlib
from typing import List, Tuple

import numpy as np

from repro_torch.core.landmarks import LandmarkStore
from repro_torch.core.video import Video

STEP_SUCCESS = 0.92
MAX_PROPAGATE = 12          # frames per direction
FLOPS_PER_FRAME = 2e7       # LK pyramid flow, ~cheap vs detection


def propagate(video: Video, store: LandmarkStore, cls: str
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (idxs, labels, counts) of flow-propagated extra samples."""
    idxs: List[int] = []
    labels: List[float] = []
    counts: List[float] = []
    n = video.spec.num_frames
    for lm in store.landmarks:
        present = lm.present(cls)
        cnt = lm.count(cls)
        rng = np.random.default_rng(
            zlib.crc32(f"flow|{video.spec.seed}|{lm.idx}".encode()) & 0x7FFFFFFF)
        for direction in (-1, 1):
            label, c = present, cnt
            for k in range(1, MAX_PROPAGATE + 1):
                j = lm.idx + direction * k
                if j < 0 or j >= n:
                    break
                if rng.uniform() > STEP_SUCCESS:
                    break                     # track lost
                # objects may genuinely enter/leave: flow only *keeps*
                # tracked boxes, so the propagated label decays toward
                # the true state with distance
                if label and rng.uniform() < 0.12:
                    label, c = False, 0.0     # tracked object left view
                idxs.append(j)
                labels.append(1.0 if label else 0.0)
                counts.append(float(c))
    if not idxs:
        return (np.zeros(0, np.int64), np.zeros(0, np.float32),
                np.zeros(0, np.float32))
    return (np.array(idxs, np.int64), np.array(labels, np.float32),
            np.array(counts, np.float32))


def flow_compute_seconds(store: LandmarkStore, tier_flops: float) -> float:
    """Camera-side cost of running flow around every landmark."""
    n_frames = len(store.landmarks) * 2 * MAX_PROPAGATE
    return n_frames * FLOPS_PER_FRAME / tier_flops
