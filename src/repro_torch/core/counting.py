"""Counting executors (§6.3).

max-Count: the camera ranks randomly-selected frames by the operator's
*count* head; uploads flow in predicted-count order; the cloud re-counts
uploads and monitors ranking quality via the Manhattan-distance metric
to decide upgrades. Completion = the cloud has seen the true max.

avg/median-Count: NO on-camera operator — the camera random-samples
frames (unbiased, LLN); landmarks provide the initial samples, which is
why accurate landmarks make these queries converge in seconds (§8.2)
and inaccurate ones slow them by orders of magnitude (§8.4).
"""
from __future__ import annotations

import heapq
from typing import List, Optional

import numpy as np

from repro_torch.core import upgrade
from repro_torch.core.query import Progress, QueryEnv
from repro_torch.core.session import QuerySession
from repro_torch.core.stepper import ScoreDemand, UploadTick, VerifyDemand, drive

RECENT_WINDOW = 24
QUALITY_TRIGGER = 0.35        # Manhattan-distance urgency threshold


class MaxCountExecutor:
    def __init__(self, env: QueryEnv, *, full_family: bool = True):
        self.env = env
        self.session = QuerySession(env, full_family=full_family,
                                    boot_salt=9)

    def run(self, max_passes: int = 8) -> Progress:
        """Drive ``steps`` standalone: uncontended uplink, scoring
        through the session's OperatorRuntime fast path."""
        return drive(self.steps(max_passes), self.session)

    def steps(self, max_passes: int = 8,
              prog: Optional[Progress] = None):
        """The executor as a stepper (see ``core/stepper``): one
        ``ScoreDemand`` (count head) per pass, one ``UploadTick`` per
        candidate-max upload."""
        env = self.env
        prog = prog if prog is not None else Progress()
        frames = env.frames
        n = len(frames)
        gt_max = int(env.gt_count.max()) if n else 0
        fps_net = env.net.frame_upload_fps
        rng = np.random.default_rng(env.video.spec.seed * 13 + 2)

        # shared bootstrap + initial ranker (count head, §6.3); the op
        # arrives after train + ship, nothing uploads meanwhile
        ses = yield from self.session.bootstrap_steps(prog)
        profiled = ses.profiled
        cur, trained, t = ses.init_ranker(prog)

        # seed best with landmark counts already on the cloud
        best = max((lm.count(env.query.cls) for lm in ses.lms), default=0)
        prog.record(t, best / max(gt_max, 1))
        if best >= gt_max:
            prog.done_t = t
            return prog

        uploaded = set()
        t_cam = t_net = t
        heap: List = []
        recent_cam: List[float] = []
        recent_cloud: List[int] = []

        for pass_no in range(max_passes):
            # random frame selection (§6.3), rank by predicted count
            unsent = np.array([i for i in frames if int(i) not in uploaded],
                              np.int64)
            if len(unsent) == 0:
                break
            order = unsent[rng.permutation(len(unsent))]
            _, counts = yield ScoreDemand(trained, order)
            dt_cam = 1.0 / max(cur.fps, 1e-9)
            ci = 0
            cam_score = {}
            upgrade_pending = False
            while True:
                if best >= gt_max:
                    prog.done_t = t_net
                    prog.record(t_net, 1.0)
                    return prog
                if ci < len(order) and t_cam <= t_net:
                    idx = int(order[ci])
                    t_cam += dt_cam
                    cam_score[idx] = float(counts[ci])
                    heapq.heappush(heap, (-counts[ci], idx))
                    ci += 1
                    continue
                entry = None
                while heap:
                    c, idx = heapq.heappop(heap)
                    if idx in uploaded or cam_score.get(idx) != -c:
                        continue
                    entry = (c, idx)
                    break
                if entry is None:
                    if ci >= len(order):
                        break
                    t_net = max(t_net, t_cam)
                    continue
                c, idx = entry
                t_net += yield UploadTick(1.0 / fps_net, env.net.frame_bytes,
                                          at=t_net)
                prog.bytes_up += env.net.frame_bytes
                uploaded.add(idx)
                _, cloud_cnt = yield VerifyDemand(idx, env.query.cls,
                                                  at=t_net)
                env.trainer.add_samples([idx], [cloud_cnt > 0], [cloud_cnt])
                recent_cam.append(-c)
                recent_cloud.append(cloud_cnt)
                if cloud_cnt > best:
                    best = cloud_cnt
                    prog.record(t_net, best / max(gt_max, 1))
                if len(recent_cam) >= RECENT_WINDOW and not upgrade_pending:
                    q = upgrade.manhattan_quality(
                        np.array(recent_cam[-RECENT_WINDOW:]),
                        np.array(recent_cloud[-RECENT_WINDOW:]))
                    if q > QUALITY_TRIGGER:
                        upgrade_pending = True
                        break
            nxt = upgrade.next_ranker(cur, profiled, fps_net, env.trainer,
                                      rank_by="count_mae")
            if nxt is not None:
                cur, trained = nxt
                t_cam = max(t_cam, t_net) + \
                    env.cloud.ship_time(cur.arch.size_bytes)
                prog.op_switches.append((t_cam, cur.name))
            recent_cam.clear()
            recent_cloud.clear()
        prog.done_t = max(t_cam, t_net)
        return prog


class SampleCountExecutor:
    """avg/median Counting: pure random sampling + LLN (§6.3)."""

    # operator-free: yields only UploadTicks, never a ScoreDemand — the
    # FleetScheduler's bucket-complete watermark uses this to exclude
    # it from the unknown-signature contributor census
    demands_scoring = False

    def __init__(self, env: QueryEnv, *, stat: str = "mean",
                 tolerance: float = 0.01, sustain: int = 20):
        assert stat in ("mean", "median")
        self.env = env
        self.stat = stat
        self.tolerance = tolerance
        self.sustain = sustain

    def run(self, max_uploads: Optional[int] = None) -> Progress:
        """Drive ``steps`` standalone (no operator: no ScoreDemands;
        verification answered synchronously through the env)."""
        return drive(self.steps(max_uploads), env=self.env)

    def steps(self, max_uploads: Optional[int] = None,
              prog: Optional[Progress] = None):
        """The executor as a stepper: pure ``UploadTick`` traffic."""
        env = self.env
        prog = prog if prog is not None else Progress()
        frames = env.frames
        gt = float(np.mean(env.gt_count)) if self.stat == "mean" \
            else float(np.median(env.gt_count))
        rng = np.random.default_rng(env.video.spec.seed * 17 + 3)
        fps_net = env.net.frame_upload_fps

        # landmarks are the initial samples (already labeled by the
        # capture-time detector; the cloud re-validates on its detector)
        lms = env.store.in_range(frames[0], frames[-1] + 1)
        t = yield UploadTick(env.net.upload_time(n_thumbs=len(lms)),
                             len(lms) * env.net.thumbnail_bytes, at=0.0)
        prog.bytes_up += len(lms) * env.net.thumbnail_bytes
        samples = [lm.count(env.query.cls) for lm in lms]

        def est() -> float:
            if not samples:
                return 0.0
            return float(np.mean(samples)) if self.stat == "mean" \
                else float(np.median(samples))

        def rel_err(e: float) -> float:
            scale = max(abs(gt), 1e-6)
            return abs(e - gt) / scale

        max_uploads = max_uploads or len(frames)
        ok_streak = 0
        e = est()
        prog.record(t, max(0.0, 1.0 - rel_err(e)))
        order = rng.permutation(len(frames))
        for k in range(max_uploads):
            if rel_err(e) <= self.tolerance:
                ok_streak += 1
                if ok_streak >= self.sustain:
                    break
            else:
                ok_streak = 0
            idx = int(frames[order[k % len(frames)]])
            t += yield UploadTick(1.0 / fps_net, env.net.frame_bytes, at=t)
            prog.bytes_up += env.net.frame_bytes
            _, cnt = yield VerifyDemand(idx, env.query.cls, at=t)
            samples.append(cnt)
            e = est()
            prog.record(t, max(0.0, 1.0 - rel_err(e)))
        prog.done_t = t
        return prog
