"""Cloud-side online operator training (§5.2-iii, §7).

``FrameBank`` renders video frames once and caches them (uint8) plus
per-(region, size) crop caches, so the many operators bred for a query
share the rendering work. ``CloudTrainer`` owns the labeled-sample pool
(landmark bootstrap -> grows with cloud-verified uploads -> optical-flow
amplification) and trains/validates operators on demand, tracking the
*simulated* training time per §8 (5-45 s/op) while running *real* PyTorch
training for the accuracy.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core import operators as ops_mod
from repro_torch.core import runtime as rt_mod
from repro_torch.core.hardware import CloudModel
from repro_torch.core.operators import OperatorArch
from repro_torch.core.video import FRAME_H, FRAME_W, Video, _resize_batch


class FrameBank:
    """Render-once frame + crop cache for one video."""

    def __init__(self, video: Video, max_frames: int = 30_000):
        self.video = video
        self.max_frames = max_frames
        self._frames: Dict[int, np.ndarray] = {}      # idx -> (H,W,3) uint8
        self._crop_cache: Dict[Tuple, Dict[int, np.ndarray]] = {}

    def frames(self, idxs) -> np.ndarray:
        idxs = [int(i) for i in idxs]
        missing = [i for i in idxs if i not in self._frames]
        if missing:
            rendered = self.video.render_frames(missing)
            for i, f in zip(missing, rendered):
                if len(self._frames) >= self.max_frames:
                    self._frames.pop(next(iter(self._frames)))
                self._frames[i] = (f * 255).astype(np.uint8)
        return np.stack([self._frames[i] for i in idxs]).astype(np.float32) / 255.0

    def crops(self, idxs, region: Optional[Tuple[int, int, int, int]],
              size: int) -> np.ndarray:
        key = (region, size)
        cache = self._crop_cache.setdefault(key, {})
        idxs = [int(i) for i in idxs]
        missing = [i for i in idxs if i not in cache]
        if missing:
            frames = self.frames(missing)
            y0, x0, y1, x1 = region if region else (0, 0, FRAME_H, FRAME_W)
            crop = frames[:, int(y0):int(y1), int(x0):int(x1), :]
            resized = _resize_batch(crop, size)
            for i, c in zip(missing, resized):
                cache[i] = (c * 255).astype(np.uint8)
        return np.stack([cache[i] for i in idxs]).astype(np.float32) / 255.0


@dataclass
class TrainedOp:
    arch: OperatorArch
    params: dict
    n_samples: int
    val_auc: float
    thresholds: Tuple[float, float]      # filter (lo, hi)
    gamma: float                         # resolvable fraction at thresholds
    count_mae: float


class CloudTrainer:
    """Labeled pool + on-demand operator training & validation."""

    def __init__(self, bank: FrameBank, cls: str, cloud: CloudModel,
                 error_budget: float = 0.01, seed: int = 0,
                 train_steps: int = 150):
        self.bank = bank
        self.cls = cls
        self.cloud = cloud
        self.error_budget = error_budget
        self.train_steps = train_steps
        self.seed = seed
        self._pool: Dict[int, Tuple[float, float]] = {}  # idx -> (label, count)
        self._trained: Dict[str, TrainedOp] = {}

    # -- sample pool ---------------------------------------------------------

    def add_samples(self, idxs, labels, counts) -> None:
        for i, lab, c in zip(idxs, labels, counts):
            self._pool[int(i)] = (float(lab), float(c))

    @property
    def n_samples(self) -> int:
        return len(self._pool)

    def _splits(self, block: int = 120):
        idxs = np.array(sorted(self._pool), np.int64)
        labels = np.array([self._pool[i][0] for i in idxs], np.float32)
        counts = np.array([self._pool[i][1] for i in idxs], np.float32)
        # group-aware 80/20 split: flow-propagated samples cluster around
        # their landmark anchor; splitting by time block keeps neighbors
        # on one side so validation measures generalization, not recall
        val = (idxs // block) % 5 == 4
        if val.all() or not val.any():
            val = (np.arange(len(idxs)) % 5) == 4
        return (idxs[~val], labels[~val], counts[~val],
                idxs[val], labels[val], counts[val])

    # -- training ------------------------------------------------------------

    def train(self, arch: OperatorArch, max_samples: int = 4000) -> TrainedOp:
        """(Re)train ``arch`` on the current pool; returns TrainedOp with
        validation metrics and calibrated thresholds."""
        ti, tl, tc, vi, vl, vc = self._splits()
        if len(ti) > max_samples:
            sel = np.random.default_rng(self.seed).choice(
                len(ti), max_samples, replace=False)
            ti, tl, tc = ti[sel], tl[sel], tc[sel]
        prev = self._trained.get(arch.name)
        params = prev.params if prev else None
        crops = self.bank.crops(ti, arch.region, arch.input_size)
        # scale step count down for expensive ops (wall-clock budget on the
        # host; simulated training time is charged separately)
        steps = int(np.clip(self.train_steps * 8e7 / max(arch.flops, 1),
                            40, self.train_steps))
        # training runs on the scoring runtime's device
        runtime = rt_mod.get_runtime()
        params = ops_mod.train_operator(
            arch, params, crops, tl, tc, steps=steps, seed=self.seed,
            device=runtime.device)
        # validate (batched through the shared OperatorRuntime)
        if len(vi):
            vcrops = self.bank.crops(vi, arch.region, arch.input_size)
            vs, vcnt = runtime.score_crops(params, arch, vcrops)
            auc = _auc(vs, vl > 0.5)
            lo, hi = ops_mod.calibrate_thresholds(vs, vl > 0.5,
                                                  self.error_budget)
            gamma = ops_mod.gamma_of(vs, lo, hi)
            mae = float(np.mean(np.abs(vcnt - vc))) if len(vc) else 1.0
        else:
            auc, lo, hi, gamma, mae = 0.5, 0.0, 1.0, 0.0, 1.0
        top = TrainedOp(arch, params, len(ti), auc, (lo, hi), gamma, mae)
        self._trained[arch.name] = top
        return top

    def get(self, name: str) -> Optional[TrainedOp]:
        return self._trained.get(name)

    def is_stale(self, name: str) -> bool:
        t = self._trained.get(name)
        return t is None or t.n_samples < 0.5 * self.n_samples

    def train_time(self, arch: OperatorArch) -> float:
        """Simulated training wall-clock (§8: 5-45 s)."""
        return self.cloud.train_time(arch.param_count, self.n_samples)


def _auc(scores: np.ndarray, labels: np.ndarray) -> float:
    """Rank AUC (probability a positive outranks a negative)."""
    pos = scores[labels]
    neg = scores[~labels]
    if len(pos) == 0 or len(neg) == 0:
        return 0.5
    order = np.argsort(np.concatenate([pos, neg]), kind="stable")
    ranks = np.empty(len(order), np.float64)
    ranks[order] = np.arange(1, len(order) + 1)
    r_pos = ranks[:len(pos)].sum()
    u = r_pos - len(pos) * (len(pos) + 1) / 2
    return float(u / (len(pos) * len(neg)))
