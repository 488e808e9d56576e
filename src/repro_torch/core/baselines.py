"""Comparison systems (§8.1, Table 3b).

CloudOnly     upload every queried frame at query time; cloud detects.
OptOp         NoScope-spirit: ONE operator specialized per query, chosen
              by a cost model minimizing full-query delay, trained once
              from landmarks (the paper's augmentation), single pass —
              no upgrades, no multi-pass.
PreIndexAll   Focus-spirit: a cheap generic detector (YOLOv3-tiny) ran on
              EVERY frame at capture; queries rank/filter on the stored
              index only — zero query-time camera compute, zero training,
              but index accuracy caps answer quality.

All share the executors' network/cloud accounting so Fig. 9/10 deltas
are apples-to-apples.
"""
from __future__ import annotations

import heapq
from typing import List

import numpy as np

from repro_torch.core import oracle
from repro_torch.core import upgrade as up
from repro_torch.core.filtering import TaggingExecutor
from repro_torch.core.hardware import YOLO_TINY
from repro_torch.core.operators import calibrate_thresholds
from repro_torch.core.query import Progress, QueryEnv
from repro_torch.core.session import QuerySession


# ---------------------------------------------------------------------------
# CloudOnly
# ---------------------------------------------------------------------------

def cloud_only_retrieval(env: QueryEnv) -> Progress:
    prog = Progress()
    frames = env.frames
    n_pos = max(env.n_positives, 1)
    t, found = 0.0, 0
    for idx in frames:
        t += 1.0 / env.net.frame_upload_fps
        prog.bytes_up += env.net.frame_bytes
        if env.is_positive(int(idx)):
            found += 1
            prog.record(t, found / n_pos)
        if found >= n_pos:
            break
    prog.done_t = t
    return prog


def cloud_only_tagging(env: QueryEnv, levels=(30, 10, 5, 2, 1)) -> Progress:
    """Upload frames level by level (1-in-K refinement order)."""
    prog = Progress()
    frames = env.frames
    n = len(frames)
    t = 0.0
    seen = np.zeros(n, bool)
    for li, K in enumerate(levels):
        for g in range(0, n, K):
            if seen[g:g + K].any():
                continue
            t += 1.0 / env.net.frame_upload_fps
            prog.bytes_up += env.net.frame_bytes
            seen[g] = True
        prog.record(t, (li + 1) / len(levels))
    prog.done_t = t
    return prog


def cloud_only_count(env: QueryEnv, stat: str, tolerance: float = 0.01,
                     sustain: int = 20) -> Progress:
    """Random-sample uploads; no landmark warm start."""
    prog = Progress()
    frames = env.frames
    rng = np.random.default_rng(env.video.spec.seed * 19 + 4)
    if stat == "max":
        gt_stat = float(env.gt_count.max())
    elif stat == "mean":
        gt_stat = float(np.mean(env.gt_count))
    else:
        gt_stat = float(np.median(env.gt_count))
    samples: List[int] = []
    t, best = 0.0, 0.0
    ok = 0
    order = rng.permutation(len(frames))
    for k in order:
        t += 1.0 / env.net.frame_upload_fps
        prog.bytes_up += env.net.frame_bytes
        _, cnt = env.cloud_verify(int(frames[k]))
        samples.append(cnt)
        if stat == "max":
            best = max(best, cnt)
            prog.record(t, best / max(gt_stat, 1.0))
            if best >= gt_stat:
                break
        else:
            e = float(np.mean(samples)) if stat == "mean" else \
                float(np.median(samples))
            err = abs(e - gt_stat) / max(abs(gt_stat), 1e-6)
            prog.record(t, max(0.0, 1.0 - err))
            ok = ok + 1 if err <= tolerance else 0
            if ok >= sustain:
                break
    prog.done_t = t
    return prog


# ---------------------------------------------------------------------------
# OptOp (NoScope-spirit)
# ---------------------------------------------------------------------------

def _optop_pick(env: QueryEnv, profiled, r_pos: float):
    """Cost model: minimize estimated full-query delay for one pass.

    delay ~= max(N / FPS_op,  N_upload / FPS_net) where N_upload shrinks
    with operator accuracy (proxy: capacity). The paper's [64] cost model
    reduced to our family: pick the op maximizing expected true-positive
    upload rate under the single-pass constraint."""
    n = env.n_frames
    fps_net = env.net.frame_upload_fps
    best, best_delay = None, float("inf")
    for p in profiled:
        acc_proxy = min(0.95, 0.6 + 0.08 * np.log10(max(p.arch.flops, 1) / 1e6))
        n_up = n * (r_pos + (1 - acc_proxy) * (1 - r_pos))
        delay = max(n / p.fps, n_up / fps_net)
        if delay < best_delay:
            best, best_delay = p, delay
    return best


def optop_retrieval(env: QueryEnv, *, full_family: bool = True) -> Progress:
    prog = Progress()
    frames = env.frames
    n = len(frames)
    n_pos = max(env.n_positives, 1)

    # OptOp gets NO long-term-knowledge operator optimization (full-frame
    # inputs only — the key ZC2 edge it lacks, §8.2-ii) and no w/o-LM
    # bootstrap machinery: landmark pull + pool seeding only.
    ses = QuerySession(env, full_family=full_family, wo_lm_fallback=False,
                       breed_from_heat=False).bootstrap(prog)
    t = ses.t
    cur = _optop_pick(env, ses.profiled, ses.r_pos)
    trained = env.trainer.train(cur.arch)
    t += env.trainer.train_time(cur.arch) + \
        env.cloud.ship_time(cur.arch.size_bytes)
    prog.op_switches.append((t, cur.name))

    # single pass, asynchronous rank+upload
    scores, _ = ses.score(trained, frames)
    t_cam = t_net = t
    dt_cam = 1.0 / max(cur.fps, 1e-9)
    heap: List = []
    uploaded = set()
    found, ci = 0, 0
    while found < n_pos and len(uploaded) < n:
        if ci < n and t_cam <= t_net:
            t_cam += dt_cam
            heapq.heappush(heap, (-scores[ci], int(frames[ci])))
            ci += 1
            continue
        entry = None
        while heap:
            s, idx = heapq.heappop(heap)
            if idx not in uploaded:
                entry = (s, idx)
                break
        if entry is None:
            if ci >= n:
                # ranked everything; upload remaining in rank order
                break
            t_net = max(t_net, t_cam)
            continue
        _, idx = entry
        t_net += 1.0 / env.net.frame_upload_fps
        prog.bytes_up += env.net.frame_bytes
        uploaded.add(idx)
        if env.is_positive(idx):
            found += 1
            prog.record(t_net, found / n_pos)
    prog.done_t = t_net
    return prog


def optop_tagging(env: QueryEnv, *, full_family: bool = True,
                  levels=(30, 10, 5, 2, 1)) -> Progress:
    """One filter, multipass refinement structure but no upgrades."""
    ex = TaggingExecutor(env, full_family=full_family, levels=levels)
    # monkey-free approach: temporarily pin upgrade.best_filter to first call
    orig = up.best_filter
    state = {}

    def pin(profiled, trainer, fps_net, exclude=(), limit=3):
        if "pick" not in state:
            # OptOp has no region-optimized ops: strip region variants
            flat = [p for p in profiled if p.arch.region is None]
            state["pick"] = orig(flat or profiled, trainer, fps_net,
                                 exclude, limit)
        return state["pick"]

    up.best_filter = pin
    try:
        prog = ex.run()
    finally:
        up.best_filter = orig
    return prog


# ---------------------------------------------------------------------------
# PreIndexAll (Focus-spirit)
# ---------------------------------------------------------------------------

def preindex_retrieval(env: QueryEnv) -> Progress:
    """Rank by the capture-time YOLOv3-tiny index; upload best-first."""
    prog = Progress()
    frames = env.frames
    n_pos = max(env.n_positives, 1)
    idx_scores = oracle.score_vec(env.video, frames, env.query.cls, YOLO_TINY)
    order = frames[np.argsort(-idx_scores, kind="stable")]
    t, found = 0.0, 0
    for idx in order:
        t += 1.0 / env.net.frame_upload_fps
        prog.bytes_up += env.net.frame_bytes
        if env.is_positive(int(idx)):
            found += 1
            prog.record(t, found / n_pos)
        if found >= n_pos:
            break
    prog.done_t = t
    return prog


def preindex_tagging(env: QueryEnv, levels=(30, 10, 5, 2, 1),
                     err: float = 0.01) -> Progress:
    """Tag from index confidences; upload frames the index can't resolve.

    Thresholds are calibrated on the landmark set (the index's own labels
    vs the accurate landmark labels), honoring the same error budget."""
    prog = Progress()
    frames = env.frames
    n = len(frames)
    # calibrate index thresholds on landmark frames
    lms = env.store.in_range(frames[0], frames[-1] + 1)
    lm_idx = np.array([lm.idx for lm in lms], np.int64)
    if len(lm_idx):
        lm_scores = oracle.score_vec(env.video, lm_idx, env.query.cls,
                                     YOLO_TINY)
        lm_labels = np.array([lm.present(env.query.cls) for lm in lms])
        lo, hi = calibrate_thresholds(lm_scores, lm_labels, err)
    else:
        lo, hi = 0.2, 0.8
    scores = oracle.score_vec(env.video, frames, env.query.cls, YOLO_TINY)
    tags = np.zeros(n, np.int8)
    t = 0.0
    for li, K in enumerate(levels):
        for g in range(0, n, K):
            grp = list(range(g, min(g + K, n)))
            if any(tags[i] != 0 for i in grp):
                continue
            # index resolves instantly (tag upload only) if confident
            resolved = False
            for i in grp:
                s = scores[i]
                if s < lo or s > hi:
                    tags[i] = 1 if s < lo else 2
                    t += env.net.tag_bytes / env.net.uplink_bytes_per_s
                    prog.bytes_up += env.net.tag_bytes
                    resolved = True
                    break
            if not resolved:
                i = grp[0]
                t += 1.0 / env.net.frame_upload_fps
                prog.bytes_up += env.net.frame_bytes
                pos, _ = env.cloud_verify(int(frames[i]))
                tags[i] = 4 if pos else 3
        prog.record(t, (li + 1) / len(levels))
    prog.done_t = t
    return prog


def preindex_count(env: QueryEnv, stat: str, tolerance: float = 0.01,
                   sustain: int = 20) -> Progress:
    """Counts seeded from the inaccurate index -> biased initial estimate
    that uploads must wash out (§8.2-i)."""
    prog = Progress()
    frames = env.frames
    rng = np.random.default_rng(env.video.spec.seed * 23 + 5)
    idx_counts = oracle.count_vec(env.video, frames[::30], env.query.cls,
                                  YOLO_TINY).astype(float).tolist()
    if stat == "max":
        gt_stat = float(env.gt_count.max())
        # index suggests candidate max frames; upload in index order
        all_counts = oracle.count_vec(env.video, frames, env.query.cls,
                                      YOLO_TINY)
        order = np.argsort(-all_counts, kind="stable")
        t, best = 0.0, 0.0
        for k in order:
            t += 1.0 / env.net.frame_upload_fps
            prog.bytes_up += env.net.frame_bytes
            _, cnt = env.cloud_verify(int(frames[k]))
            best = max(best, cnt)
            prog.record(t, best / max(gt_stat, 1.0))
            if best >= gt_stat:
                break
        prog.done_t = t
        return prog
    gt_stat = float(np.mean(env.gt_count)) if stat == "mean" else \
        float(np.median(env.gt_count))
    samples = idx_counts                  # biased seed
    t, ok = 0.0, 0
    order = rng.permutation(len(frames))
    for k in order:
        e = float(np.mean(samples)) if stat == "mean" else \
            float(np.median(samples))
        err = abs(e - gt_stat) / max(abs(gt_stat), 1e-6)
        prog.record(t, max(0.0, 1.0 - err))
        if err <= tolerance:
            ok += 1
            if ok >= sustain:
                break
        else:
            ok = 0
        t += 1.0 / env.net.frame_upload_fps
        prog.bytes_up += env.net.frame_bytes
        _, cnt = env.cloud_verify(int(frames[k]))
        samples.append(cnt)
    prog.done_t = t
    return prog
