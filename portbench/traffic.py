"""The one traffic generator: a traffic file's parameters and ``--seed``
give the batches of a run.

Training (``driver: train``): a pool of ``pool`` batches of ``batch`` x
``seq_len`` tokens from the frozen ``TokenPipeline``, every row
distinct, cycled in order. Every seed offers the same work: the same
shapes, other token ids.
"""
from __future__ import annotations

from typing import Dict, List

from portbench.tokens import TokenPipeline


def train_pool(cfg: Dict, traffic: Dict, seed: int) -> List[Dict]:
    """``pool`` batches (``tokens``, ``labels`` (batch, seq_len) int32)."""
    B, n = traffic["batch"], traffic["pool"]
    rows = TokenPipeline(cfg["vocab_size"], seed).batch_at(
        0, B * n, traffic["seq_len"])
    return [{k: v[i * B:(i + 1) * B].copy() for k, v in rows.items()}
            for i in range(n)]
