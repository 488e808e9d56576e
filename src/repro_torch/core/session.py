"""QuerySession — the shared per-query bootstrap + scoring substrate.

Every executor used to copy-paste the same opening sequence: landmark
pull with thumbnail byte accounting, landmark (and optical-flow)
training-set seeding, the §8.4 "w/o LM" random-upload fallback,
heatmap / temporal-density / positive-ratio derivation, operator-family
breeding + profiling, and the initial-operator pick with train/ship
time accounting. ``QuerySession`` owns that sequence once, plus the
``OperatorRuntime`` scoring fast path, so executors are thin event
loops and a new query kind composes these pieces instead of
re-implementing them (see docs/ARCHITECTURE.md).

Knobs mirror the executors' historical differences exactly so seeded
runs are bit-identical to the pre-refactor code: ``boot_salt`` keeps
each executor's w/o-LM RNG stream, ``use_flow`` is ranking-only,
``density_grain`` enables the temporal-density prior, ``use_longterm``
is the Fig. 12 ablation, and ``wo_lm_fallback``/``breed_from_heat``
turn off ZC2-only machinery for baselines (OptOp breeds full-frame
operators and never sees the fallback).
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import factory, flow, landmarks as lm_mod, upgrade
from repro_torch.core.factory import ProfiledOp
from repro_torch.core.query import Progress, QueryEnv
from repro_torch.core.runtime import OperatorRuntime, get_runtime
from repro_torch.core.stepper import UploadTick, VerifyDemand, drive
from repro_torch.core.training import TrainedOp


class QuerySession:
    def __init__(self, env: QueryEnv, *,
                 full_family: bool = True,
                 use_flow: bool = False,
                 use_longterm: bool = True,
                 boot_salt: int = 7,
                 wo_lm_fallback: bool = True,
                 breed_from_heat: bool = True,
                 density_grain: Optional[int] = None):
        self.env = env
        self.full_family = full_family
        self.use_flow = use_flow
        self.use_longterm = use_longterm
        self.boot_salt = boot_salt
        self.wo_lm_fallback = wo_lm_fallback
        self.breed_from_heat = breed_from_heat
        self.density_grain = density_grain
        # populated by bootstrap()
        self.t = 0.0
        self.lms: List = []
        self.heat: Optional[np.ndarray] = None
        self.density: Optional[np.ndarray] = None
        self.r_pos = 0.0
        self.profiled: List[ProfiledOp] = []

    @property
    def fps_net(self) -> float:
        return self.env.net.frame_upload_fps

    @property
    def dt_net(self) -> float:
        return 1.0 / self.fps_net

    # -- bootstrap (§5.2, §8.4) ----------------------------------------------

    def bootstrap(self, prog: Progress) -> "QuerySession":
        """Eager ``bootstrap_steps``: uncontended uplink, synchronous
        cloud verification (baselines and pre-fleet callers). Advances
        ``self.t`` and charges ``prog.bytes_up``."""
        return drive(self.bootstrap_steps(prog), env=self.env)

    def bootstrap_steps(self, prog: Progress):
        """Pull landmarks, seed the training pool, derive long-term
        knowledge, breed + profile the operator family. A stepper
        (yields ``UploadTick`` per uplink transfer — see
        ``core/stepper``); executors ``yield from`` it. Advances
        ``self.t`` and charges ``prog.bytes_up``."""
        env = self.env
        frames = env.frames
        n = len(frames)

        # 1. landmark pull (thumbnails) + bootstrap training set
        self.lms = env.store.in_range(frames[0], frames[-1] + 1)
        self.t = yield UploadTick(env.net.upload_time(n_thumbs=len(self.lms)),
                                  len(self.lms) * env.net.thumbnail_bytes,
                                  at=0.0)
        prog.bytes_up += len(self.lms) * env.net.thumbnail_bytes
        li, ll, lc = lm_mod.training_set(env.store, env.query.cls)
        env.trainer.add_samples(li, ll, lc)
        if self.use_flow and len(self.lms):
            fi, fl, fc = flow.propagate(env.video, env.store, env.query.cls)
            env.trainer.add_samples(fi, fl, fc)

        # 2. w/o-landmark bootstrap (§8.4 "w/o LM"): the camera uploads
        # random unlabeled frames for the cloud to label until a minimal
        # training pool exists
        if self.wo_lm_fallback and env.trainer.n_samples < 30:
            rng = np.random.default_rng(
                env.video.spec.seed * 31 + self.boot_salt)
            for idx in rng.choice(frames, min(60, n), replace=False):
                self.t += yield UploadTick(self.dt_net, env.net.frame_bytes,
                                           at=self.t)
                prog.bytes_up += env.net.frame_bytes
                pos, cnt = yield VerifyDemand(int(idx), env.query.cls,
                                              at=self.t)
                env.trainer.add_samples([int(idx)], [pos], [cnt])

        # 3. long-term knowledge: spatial skew + temporal density
        self.r_pos = lm_mod.positive_ratio(env.store, env.query.cls)
        self.heat = lm_mod.heatmap(env.store, env.query.cls)
        if self.density_grain is not None:
            self.density = lm_mod.temporal_density(
                env.store, env.query.cls, env.video.spec.num_frames,
                self.density_grain)
        if not self.use_longterm:          # Fig. 12 ablation
            self.heat = np.zeros_like(self.heat)
            if self.density is not None:
                self.density = np.zeros_like(self.density)

        # 4. operator family
        heat = self.heat if (self.breed_from_heat and
                             self.heat.sum() > 0) else None
        self.profiled = factory.profile(
            factory.breed(heat, full=self.full_family), env.tier)
        return self

    # -- initial operator pick -----------------------------------------------

    def init_ranker(self, prog: Progress
                    ) -> Tuple[ProfiledOp, TrainedOp, float]:
        """§6.1 rule 1: most accurate feasible ranker; returns
        ``(op, trained, ready_t)`` where ready_t charges cloud training
        plus shipping. ``self.t`` is left at the bootstrap clock so
        callers may overlap uploads with training (ranking does)."""
        env = self.env
        cur = upgrade.initial_ranker(self.profiled, self.fps_net, self.r_pos)
        trained = env.trainer.train(cur.arch)
        ready = self.t + env.trainer.train_time(cur.arch) + \
            env.cloud.ship_time(cur.arch.size_bytes)
        prog.op_switches.append((ready, cur.name))
        return cur, trained, ready

    def init_filter(self, prog: Progress
                    ) -> Tuple[ProfiledOp, TrainedOp, float]:
        """§6.2: highest effective-tagging-rate filter; advances
        ``self.t`` past training + shipping."""
        env = self.env
        pick = upgrade.best_filter(self.profiled, env.trainer, self.fps_net)
        assert pick is not None
        cur, trained, rate = pick
        self.t += env.trainer.train_time(cur.arch) + \
            env.cloud.ship_time(cur.arch.size_bytes)
        prog.op_switches.append((self.t, cur.name))
        return cur, trained, rate

    # -- scoring (OperatorRuntime fast path) -----------------------------------

    @property
    def runtime(self) -> OperatorRuntime:
        """Always the process-global runtime — the same one the cloud
        trainer calibrates thresholds through, so scores and the
        thresholds that gate them share one numeric path."""
        return get_runtime()

    def score(self, trained: TrainedOp, idxs
              ) -> Tuple[np.ndarray, np.ndarray]:
        """Batched (presence_prob, count) over frame indices.

        Single-demand scoring through the runtime's adaptive dispatch
        layers (lean small-shape below the flops threshold, bucketed
        above it) — bit-identical to the fleet's superbatched path, so
        a query scored here and the same query scored under a
        ``FleetScheduler`` produce the same Progress (see
        docs/ARCHITECTURE.md "Dispatch layers")."""
        return self.runtime.score(trained, self.env.bank, idxs)
