"""A frozen copy of ``repro_torch/train/data.py``'s ``TokenPipeline``:
Zipf-distributed token streams with sparse bigram structure, each batch
a pure function of (seed, step). Copied so that a change to the
program's pipeline cannot move the benchmark's inputs."""
from __future__ import annotations

import numpy as np


class TokenPipeline:
    def __init__(self, vocab_size: int, seed: int, zipf_a: float = 1.2):
        self.vocab_size, self.seed = vocab_size, seed
        base = np.random.default_rng(seed)
        self._succ = base.integers(0, vocab_size, size=(vocab_size, 4))
        p = 1.0 / np.arange(1, vocab_size + 1, dtype=np.float64) ** zipf_a
        self._p = p / p.sum()

    def batch_at(self, step: int, batch: int, seq_len: int) -> dict:
        """``tokens`` and ``labels`` (batch, seq_len) int32: each row a
        stream of seq_len + 1 tokens, the labels the tokens shifted by
        one."""
        v = self.vocab_size
        rng = np.random.default_rng((self.seed * 1_000_003 + step) & 0x7FFFFFFF)
        toks = np.empty((batch, seq_len + 1), np.int32)
        toks[:, 0] = rng.choice(v, size=batch, p=self._p)
        follow = rng.uniform(size=(batch, seq_len)) < 0.65
        succ_pick = rng.integers(0, 4, size=(batch, seq_len))
        fresh = rng.choice(v, size=(batch, seq_len), p=self._p)
        for t in range(seq_len):
            toks[:, t + 1] = np.where(follow[:, t],
                                      self._succ[toks[:, t], succ_pick[:, t]],
                                      fresh[:, t])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
