"""Each kernel's needed operations and bytes, from its shapes. The
formulas are those of the port's ``cost()`` functions as they stood
when the benchmark was defined (flash attention backward: 10·D operations a
kept (q, k) pair of each query head; ``moe_gmm``:
2 a multiply-add forward, twice that backward), each input read once
and each output written once. ``portbench/tests/test_portbench_counts``
holds them to those values."""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def kept_pairs(sq: int, sk: int, window: Optional[int], causal: bool = True) -> int:
    """(q, k) pairs of one sequence and head that a causal, optionally
    sliding, mask keeps: query i (aligned to the end of the keys) keeps
    key j iff j <= i and j > i - window."""
    pos = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(pos, sk - 1) if causal else np.full_like(pos, sk - 1)
    lo = np.maximum(0, pos - window + 1) if window else np.zeros_like(pos)
    return int(np.sum(np.maximum(hi - lo + 1, 0)))


def flash_bwd(B: int, S: int, H: int, KV: int, D: int, window: Optional[int],
              itemsize: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of one backward (dQ, then dK and dV): q, out,
    dout, dq and k, v, dk, dv each crossing memory once, the float32
    log-sum-exp read."""
    pairs = B * kept_pairs(S, S, window)
    nbytes = (4 * B * S * H * D + 4 * B * S * KV * D) * itemsize
    return 10 * D * H * pairs, nbytes + 4 * B * H * S


def gmm_fwd(E: int, rows: int, d: int, f: int,
            itemsize: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of one grouped product of ``rows`` routed rows
    of width d by E experts' (d, f) weights: the rows read and their
    products written once, every expert's weight read once."""
    return 2 * rows * d * f, (rows * d + E * d * f + rows * f) * itemsize


def gmm_bwd(E: int, rows: int, d: int, f: int,
            itemsize: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of its backward, dx and dw: x, w and dy read
    once, dx and dw written once."""
    return 4 * rows * d * f, (2 * rows * d + 2 * E * d * f + rows * f) * itemsize
