"""Online operator-upgrade policies (§5, §6).

All constants are the paper's: alpha=0.5 (exponential slow-down for
ranker upgrades), k=5 (upload-quality decline trigger), beta=2
(effective-tagging-rate upgrade factor).

``f_op = FPS_op / FPS_net`` is the operator's speed relative to upload;
it is re-evaluated against the *measured* FPS_net at every upgrade, so
the policy adapts to bandwidth changes mid-query (§6.1).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.factory import ProfiledOp
from repro_torch.core.training import CloudTrainer, TrainedOp

ALPHA = 0.5
K_DECLINE = 5.0
BETA = 2.0
MAX_CANDIDATES_PER_DECISION = 3


def f_of(op: ProfiledOp, fps_net: float) -> float:
    return op.fps / max(fps_net, 1e-9)


def initial_ranker(profiled: Sequence[ProfiledOp], fps_net: float,
                   r_pos: float) -> ProfiledOp:
    """Most accurate operator among those fast enough: f_op * R_pos > 1
    (§6.1-1). Capacity (flops) is the pre-training accuracy proxy; the
    selected op is then actually trained and validated."""
    feasible = [p for p in profiled if f_of(p, fps_net) * max(r_pos, 1e-3) > 1.0]
    if not feasible:
        return max(profiled, key=lambda p: p.fps)        # explore fastest
    return max(feasible, key=lambda p: p.arch.flops)


def quality_declined(recent_ratio: float, initial_ratio: float,
                     k: float = K_DECLINE) -> bool:
    """§6.1-2: positive ratio in recent uploads k-times lower than at start."""
    return recent_ratio < initial_ratio / k


def next_ranker(current: ProfiledOp, profiled: Sequence[ProfiledOp],
                fps_net: float, trainer: CloudTrainer,
                rank_by: str = "val_auc") -> Optional[Tuple[ProfiledOp, TrainedOp]]:
    """§6.1-3: among much slower ops with f_next >= alpha * f_cur, train
    up to MAX_CANDIDATES and pick the most accurate (validated)."""
    f_cur = f_of(current, fps_net)
    band = [p for p in profiled
            if f_of(p, fps_net) < f_cur and f_of(p, fps_net) >= ALPHA * f_cur]
    if not band:
        slower = [p for p in profiled if f_of(p, fps_net) < f_cur]
        if not slower:
            return None
        band = [max(slower, key=lambda p: f_of(p, fps_net))]
    band = sorted(band, key=lambda p: -p.arch.flops)[:MAX_CANDIDATES_PER_DECISION]
    trained = [(p, trainer.train(p.arch)) for p in band]
    key = (lambda pt: pt[1].val_auc) if rank_by == "val_auc" else \
        (lambda pt: -pt[1].count_mae)
    return max(trained, key=key)


def effective_tagging_rate(op: ProfiledOp, trained: TrainedOp,
                           fps_net: float) -> float:
    """§6.2: FPS_op * gamma_op + FPS_net."""
    return op.fps * trained.gamma + fps_net


def best_filter(profiled: Sequence[ProfiledOp], trainer: CloudTrainer,
                fps_net: float, exclude: Sequence[str] = (),
                limit: int = MAX_CANDIDATES_PER_DECISION
                ) -> Optional[Tuple[ProfiledOp, TrainedOp, float]]:
    """Train (lazily) a spread of candidates and pick the highest
    effective tagging rate."""
    cands = [p for p in profiled if p.name not in exclude]
    if not cands:
        return None
    # spread across the speed ladder: fastest, middle, most capable
    cands = sorted(cands, key=lambda p: -p.fps)
    picks = {0, len(cands) // 2, len(cands) - 1}
    chosen = [cands[i] for i in sorted(picks)][:limit]
    best = None
    for p in chosen:
        t = trainer.get(p.name)
        if t is None or trainer.is_stale(p.name):
            t = trainer.train(p.arch)
        rate = effective_tagging_rate(p, t, fps_net)
        if best is None or rate > best[2]:
            best = (p, t, rate)
    return best


def should_upgrade_filter(current_rate: float, candidate_rate: float,
                          beta: float = BETA) -> bool:
    return candidate_rate >= beta * current_rate


def manhattan_quality(camera_scores: np.ndarray,
                      cloud_counts: np.ndarray) -> float:
    """§6.3 max-Count upload-quality metric: Manhattan distance between
    the camera's ranking of recent uploads and the cloud's re-ranking.
    Normalized to [0,1]; higher = worse quality = more upgrade urgency."""
    n = len(camera_scores)
    if n < 4:
        return 0.0
    cam_rank = np.argsort(np.argsort(-camera_scores, kind="stable"))
    cloud_rank = np.argsort(np.argsort(-cloud_counts, kind="stable"))
    dist = np.abs(cam_rank - cloud_rank).sum()
    worst = (n * n) // 2
    return float(dist / max(worst, 1))
