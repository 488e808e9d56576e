"""Multipass ranking executor — Retrieval queries (§5.2, §6.1, Fig. 7).

Two concurrent lanes, discrete-event simulated:
  camera lane  ranks frames with the current operator (1/FPS_op each),
               pass after pass (cheap explorer first, upgraded ops
               re-rank the shrinking unsent remainder);
  network lane uploads the best-scored *available* frame (1/FPS_net
               each) — asynchronously (§3 notable design 4): upload
               starts long before a ranking pass finishes, and a frame
               becomes available only after its ranking (causality is
               enforced by AsyncUploadQueue and property-tested).

Operator scores are real PyTorch inference (batched per pass); time comes
from the hardware cost models. The cloud verifies every upload with the
cloud detector, feeds verified labels back into the training pool, and
runs the §6.1 upgrade policy: k-rule trigger on upload-quality decline,
alpha-band (exponential slow-down) selection of the next operator.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np

from repro_torch.core import upgrade
from repro_torch.core.query import Progress, QueryEnv
from repro_torch.core.queue import AsyncUploadQueue
from repro_torch.core.session import QuerySession
from repro_torch.core.skew import rank_spans
from repro_torch.core.stepper import ScoreDemand, UploadTick, VerifyDemand, drive

RECENT_WINDOW = 30


class RetrievalExecutor:
    def __init__(self, env: QueryEnv, *, full_family: bool = True,
                 grain_frames: Optional[int] = None,
                 use_flow: bool = True,
                 use_upgrade: bool = True,
                 use_longterm: bool = True):
        """``use_upgrade``/``use_longterm`` are the Fig. 12 ablations:
        no-upgrade keeps the initial operator for the whole query
        (retraining allowed, no switches); no-longterm drops the
        spatial-skew operator crops and the temporal span priority."""
        self.env = env
        self.use_upgrade = use_upgrade
        self.grain = grain_frames or max(1, env.n_frames // 12)
        self.session = QuerySession(
            env, full_family=full_family, use_flow=use_flow,
            use_longterm=use_longterm, boot_salt=7,
            density_grain=self.grain)

    def run(self, max_passes: int = 12) -> Progress:
        """Drive ``steps`` standalone: uncontended uplink, scoring
        through the session's OperatorRuntime fast path."""
        return drive(self.steps(max_passes), self.session)

    def steps(self, max_passes: int = 12,
              prog: Optional[Progress] = None):
        """The executor as a stepper (see ``core/stepper``): the
        historical event loop, yielding ``ScoreDemand`` per ranking pass
        and ``UploadTick`` per uplink transfer."""
        env = self.env
        prog = prog if prog is not None else Progress()
        frames = env.frames
        n = len(frames)
        n_pos = max(env.n_positives, 1)
        fps_net = env.net.frame_upload_fps
        dt_net = 1.0 / fps_net

        # 1.-2. shared bootstrap + initial op (§6.1 rule 1); the camera
        # keeps uploading while the initial op trains/ships, so ``t``
        # stays at the bootstrap clock and ``arrive`` is the op's ETA.
        ses = yield from self.session.bootstrap_steps(prog)
        t = ses.t
        density = ses.density
        profiled = ses.profiled
        cur, trained, arrive = ses.init_ranker(prog)

        q = AsyncUploadQueue()
        found = 0

        def verify_upload(idx: int, t_up: float):
            """Sub-stepper (``yield from``): cloud verification of one
            upload, answered by the driver (synchronously under
            ``drive``, via the shared OracleService under a fleet)."""
            nonlocal found
            prog.bytes_up += env.net.frame_bytes
            q.mark_uploaded(idx)
            pos, cnt = yield VerifyDemand(int(idx), env.query.cls, at=t_up)
            env.trainer.add_samples([idx], [pos], [cnt])
            if pos:
                found += 1
                prog.record(t_up, found / n_pos)

        # 3. bootstrap uploads: top-density spans, unranked, until op arrives
        spans = rank_spans(density, self.grain, env.video.spec.num_frames)
        boot_order = [i for (a, b) in spans for i in range(a, b)
                      if frames[0] <= i <= frames[-1]]
        bi = 0
        while t + dt_net <= arrive and bi < len(boot_order):
            idx = boot_order[bi]
            bi += 1
            if q.uploaded(idx):
                continue
            t += yield UploadTick(dt_net, env.net.frame_bytes, at=t)
            yield from verify_upload(idx, t)

        # 4. multipass ranking
        t_cam = t_net = arrive
        recent: List[bool] = []
        initial_ratio: Optional[float] = None
        pending_arrival: Optional[float] = None
        pending_op = None

        def build_pass_order(first: bool) -> np.ndarray:
            unsent = np.array([i for i in frames if not q.uploaded(int(i))],
                              np.int64)
            if first:
                order = [i for (a, b) in spans for i in range(a, b)]
                inset = set(unsent.tolist())
                return np.array([i for i in order if i in inset], np.int64)
            # §6.1: existing ranking order; never-ranked frames enter at 0.5
            sc = np.array([q.current_score(int(i)) for i in unsent])
            return unsent[np.argsort(-sc, kind="stable")]

        def drain_network(until: float):
            """Advance the network lane up to time ``until``; returns True
            when the query completed. (A sub-stepper: ``yield from``.)"""
            nonlocal t_net, initial_ratio, pending_op, pending_arrival
            while t_net < until:
                if found >= n_pos or q.n_uploaded >= n:
                    return True
                idx, t_next = q.pop_best(t_net)
                if idx is None:
                    if t_next is None or t_next > until:
                        t_net = until
                        return False
                    t_net = max(t_net, t_next)
                    continue
                t_net += yield UploadTick(dt_net, env.net.frame_bytes,
                                          at=t_net)
                yield from verify_upload(idx, t_net)
                recent.append(env.is_positive(idx))
                # ---- cloud upgrade policy (k-rule trigger, §6.1-2) ----
                if len(recent) >= RECENT_WINDOW:
                    ratio = float(np.mean(recent[-RECENT_WINDOW:]))
                    if initial_ratio is None:
                        initial_ratio = max(ratio, 1e-3)
                    if (self.use_upgrade and pending_arrival is None and
                            upgrade.quality_declined(ratio, initial_ratio)):
                        nxt = upgrade.next_ranker(cur, profiled, fps_net,
                                                  env.trainer)
                        if nxt is not None and nxt[0].name != cur.name:
                            pending_op = nxt
                            pending_arrival = t_net + env.cloud.ship_time(
                                nxt[0].arch.size_bytes)
            return found >= n_pos or q.n_uploaded >= n

        stagnant = 0
        for pass_no in range(max_passes):
            order = build_pass_order(first=pass_no == 0)
            if len(order) == 0:
                break
            scores, _ = yield ScoreDemand(trained, order)
            dt_cam = 1.0 / max(cur.fps, 1e-9)
            interrupted = False
            # camera ranks the whole pass; the network drains concurrently
            for ci in range(len(order)):
                idx = int(order[ci])
                if q.uploaded(idx):
                    continue
                t_cam += dt_cam
                q.rank(t_cam, idx, float(scores[ci]))
                if (yield from drain_network(t_cam)):
                    prog.done_t = t_net
                    return prog
                if pending_arrival is not None and t_cam >= pending_arrival:
                    interrupted = True      # new op arrived mid-pass
                    break
            # ---- pass boundary (§6.1: op finished all frames, or k-rule) ----
            if found >= n_pos or q.n_uploaded >= n:
                break
            if interrupted and pending_op is not None:
                cur, trained = pending_op
                t_cam = max(t_cam, pending_arrival)
                prog.op_switches.append((t_cam, cur.name))
                pending_op, pending_arrival = None, None
                initial_ratio = None
                recent.clear()
                stagnant = 0
            else:
                nxt = upgrade.next_ranker(cur, profiled, fps_net,
                                          env.trainer) \
                    if self.use_upgrade else None
                if nxt is not None and nxt[0].name != cur.name:
                    cur, trained = nxt
                    arr = t_cam + env.cloud.ship_time(cur.arch.size_bytes)
                    if (yield from drain_network(arr)):
                        prog.done_t = t_net
                        return prog
                    t_cam = max(t_cam, arr)
                    prog.op_switches.append((t_cam, cur.name))
                    initial_ratio = None
                    recent.clear()
                    stagnant = 0
                else:
                    # no slower op left: retrain current on the grown pool
                    trained = env.trainer.train(cur.arch)
                    stagnant += 1
                    if stagnant >= 2:
                        break               # ranking converged; just drain
        # drain the queue (current best ranking), then any never-ranked frames
        while found < n_pos and q.n_uploaded < n:
            idx, t_next = q.pop_best(t_net)
            if idx is None:
                if t_next is None:
                    break
                t_net = max(t_net, t_next)
                continue
            t_net += yield UploadTick(dt_net, env.net.frame_bytes,
                                      at=t_net)
            yield from verify_upload(idx, t_net)
        for idx in frames:
            if found >= n_pos:
                break
            if q.uploaded(int(idx)):
                continue
            t_net += yield UploadTick(dt_net, env.net.frame_bytes,
                                      at=t_net)
            yield from verify_upload(int(idx), t_net)
        prog.done_t = t_net
        return prog
