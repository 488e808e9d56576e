"""Multipass filtering executor — Tagging queries (§6.2, Algorithm 1).

Refinement levels K = 30, 10, 5, 2, 1: each pass guarantees at least one
tagged frame per K adjacent frames. A pass runs the paper's two stages:
  rapid attempting — one random untagged frame per unresolved group;
                     unresolvable frames go to the upload queue;
  work stealing    — the camera pulls from the upload queue *tail* and
                     tries other frames of that group, cancelling the
                     pending upload on success.
Upload and camera compute are concurrent lanes; the effective tagging
rate FPS_op * gamma_op + FPS_net drives operator selection with the
beta=2 upgrade rule (evaluated at pass boundaries).

Scores under the current operator are computed in one real PyTorch batch per
pass; the event loop then charges per-frame camera time as it "reveals"
them — identical results to frame-at-a-time execution, without 40k
single-frame dispatches.

Camera tags (P/N within the calibrated thresholds' error budget) cost
tag_bytes; unresolved frames cost a full-frame upload and are tagged
authoritatively by the cloud.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Optional, Set

import numpy as np

from repro_torch.core import upgrade
from repro_torch.core.query import Progress, QueryEnv
from repro_torch.core.session import QuerySession
from repro_torch.core.stepper import ScoreDemand, UploadTick, VerifyDemand, drive

LEVELS = (30, 10, 5, 2, 1)


class TaggingExecutor:
    def __init__(self, env: QueryEnv, *, full_family: bool = True,
                 levels=LEVELS, use_upgrade: bool = True,
                 use_longterm: bool = True):
        """``use_upgrade``/``use_longterm``: Fig. 12 ablations (no filter
        switches after the initial pick / no spatial-skew crops)."""
        self.env = env
        self.levels = levels
        self.use_upgrade = use_upgrade
        self.tags = None          # exposed for accuracy checks/tests
        self.session = QuerySession(env, full_family=full_family,
                                    use_longterm=use_longterm, boot_salt=8)

    def run(self) -> Progress:
        """Drive ``steps`` standalone: uncontended uplink, scoring
        through the session's OperatorRuntime fast path."""
        return drive(self.steps(), self.session)

    def steps(self, prog: Optional[Progress] = None):
        """The executor as a stepper (see ``core/stepper``): one
        ``ScoreDemand`` per refinement pass, one ``UploadTick`` per
        unresolved-frame upload (camera tag bytes are charged but are
        too small to contend for the uplink)."""
        env = self.env
        prog = prog if prog is not None else Progress()
        frames = env.frames
        n = len(frames)
        rng = np.random.default_rng(env.video.spec.seed * 7 + 1)
        fps_net = env.net.frame_upload_fps
        dt_net = 1.0 / fps_net

        # shared bootstrap + initial filter (§6.2): ``t`` lands past the
        # initial filter's train + ship time
        ses = yield from self.session.bootstrap_steps(prog)
        profiled = ses.profiled
        cur, trained, cur_rate = ses.init_filter(prog)
        t = ses.t

        # tags: 0 untagged | 1 N(cam) | 2 P(cam) | 3 N(cloud) | 4 P(cloud)
        tags = np.zeros(n, np.int8)
        self.tags = tags
        t_cam = t_net = t

        def upload(i: int, start: float):
            """Sub-stepper: ``yield from``."""
            nonlocal t_net
            t_net = start + (yield UploadTick(dt_net, env.net.frame_bytes,
                                              at=start))
            prog.bytes_up += env.net.frame_bytes
            pos, cnt = yield VerifyDemand(int(frames[i]), env.query.cls,
                                          at=t_net)
            tags[i] = 4 if pos else 3
            env.trainer.add_samples([int(frames[i])], [pos], [cnt])
            return t_net

        for li_, K in enumerate(self.levels):
            # ---- operator upgrade at pass boundary (beta rule) ----
            if li_ > 0 and self.use_upgrade:
                pick = upgrade.best_filter(profiled, env.trainer, fps_net)
                if pick is not None and pick[0].name != cur.name and \
                        upgrade.should_upgrade_filter(cur_rate, pick[2]):
                    cur, trained, cur_rate = pick
                    arr = max(t_cam, t_net) + \
                        env.cloud.ship_time(cur.arch.size_bytes)
                    t_cam = max(t_cam, arr)
                    prog.op_switches.append((t_cam, cur.name))
            lo, hi = trained.thresholds
            dt_cam = 1.0 / max(cur.fps, 1e-9)

            untagged = np.nonzero(tags == 0)[0]
            sc = np.full(n, np.nan)
            if len(untagged):
                probs, _ = yield ScoreDemand(trained, frames[untagged])
                sc[untagged] = probs

            def attempt(i: int, attempted: Set[int]) -> bool:
                """Camera attempts frame i; True iff resolved on camera."""
                nonlocal t_cam
                t_cam += dt_cam
                s = sc[i]
                if s < lo:
                    tags[i] = 1
                    prog.bytes_up += env.net.tag_bytes
                    return True
                if s > hi:
                    tags[i] = 2
                    prog.bytes_up += env.net.tag_bytes
                    return True
                attempted.add(i)
                return False

            queue: Deque[int] = deque()
            attempted: Set[int] = set()
            groups = [(g, min(g + K, n)) for g in range(0, n, K)]

            # ---- stage 1: rapid attempting (camera); uploads concurrent ----
            for (g0, g1) in groups:
                members = list(range(g0, g1))
                if any(tags[i] != 0 for i in members):
                    continue
                i = members[int(rng.integers(len(members)))]
                if not attempt(i, attempted):
                    queue.append(i)
                # network lane keeps pace with camera clock
                while queue and t_net < t_cam:
                    j = queue.popleft()
                    if tags[j] == 0:
                        yield from upload(j, max(t_net, 0.0))

            # ---- stage 2: work stealing (two lanes until queue drains) ----
            while queue:
                if t_net <= t_cam:
                    j = queue.popleft()
                    if tags[j] == 0:
                        yield from upload(j, t_net)
                    continue
                # camera steals from the tail
                i = queue[-1]
                g0 = (i // K) * K
                members = [j for j in range(g0, min(g0 + K, n))
                           if tags[j] == 0 and j not in attempted and j != i]
                stolen = False
                for j in members:
                    if attempt(j, attempted):
                        stolen = True
                        break
                if stolen:
                    queue.remove(i)       # pending upload cancelled
                elif not members:
                    # camera cannot help this group: let the upload happen
                    queue.remove(i)
                    yield from upload(i, max(t_net, t_cam))
            t_done = max(t_cam, t_net)
            prog.record(t_done, (li_ + 1) / len(self.levels))
        prog.done_t = max(t_cam, t_net)
        return prog


def tag_accuracy(env: QueryEnv, tags: np.ndarray) -> dict:
    """Camera-tag error rates vs cloud ground truth (error-budget check).

    ``fn_rate``/``fp_rate`` use the paper's budget semantics (§6.2):
    camera false negatives over ALL positives, false positives over ALL
    negatives — the same denominators ``calibrate_thresholds`` bounds.
    ``false_neg``/``false_pos`` are the per-camera-tag precisions."""
    cam_p = tags == 2
    cam_n = tags == 1
    gt = env.gt_positive
    fp = float((cam_p & ~gt).sum() / max(cam_p.sum(), 1))
    fn = float((cam_n & gt).sum() / max(cam_n.sum(), 1))
    fn_rate = float((cam_n & gt).sum() / max(gt.sum(), 1))
    fp_rate = float((cam_p & ~gt).sum() / max((~gt).sum(), 1))
    agree = float((((tags == 2) | (tags == 4)) == gt).mean()) if len(tags) \
        else 1.0
    return {"false_pos": fp, "false_neg": fn,
            "fp_rate": fp_rate, "fn_rate": fn_rate, "agreement": agree}
