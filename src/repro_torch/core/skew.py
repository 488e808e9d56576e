"""Long-term skew exploitation (§4): k-enclosing regions and span ranking.

``k_enclosing_region`` finds a small axis-aligned box covering a target
fraction of the heatmap mass (the paper uses the k-enclosing algorithm
[73] to carve operator input regions). We search (integral-image
cumulative sums, coarse stride with refinement) for the minimum-area box
at the requested coverage — exact enough that operators trained on the
crop see >=coverage of the objects.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def _integral(h: np.ndarray) -> np.ndarray:
    ii = np.zeros((h.shape[0] + 1, h.shape[1] + 1), np.float64)
    ii[1:, 1:] = np.cumsum(np.cumsum(h, 0), 1)
    return ii


def _box_sum(ii: np.ndarray, y0: int, x0: int, y1: int, x1: int) -> float:
    return ii[y1, x1] - ii[y0, x1] - ii[y1, x0] + ii[y0, x0]


def k_enclosing_region(heat: np.ndarray, coverage: float = 0.95,
                       stride: int = 4) -> Tuple[int, int, int, int]:
    """Smallest-area (y0, x0, y1, x1) with >= coverage of total mass."""
    H, W = heat.shape
    total = heat.sum()
    if total <= 0:
        return (0, 0, H, W)
    target = coverage * total
    ii = _integral(heat)
    best = (0, 0, H, W)
    best_area = H * W + 1
    hs = list(range(stride, H + 1, stride))
    ws = list(range(stride, W + 1, stride))
    for bh in hs:
        for bw in ws:
            if bh * bw >= best_area:
                continue
            # slide at stride granularity
            found = False
            for y0 in range(0, H - bh + 1, stride):
                row = ii[y0 + bh, bw:W + 1:stride] - ii[y0, bw:W + 1:stride] \
                    - ii[y0 + bh, 0:W - bw + 1:stride] + ii[y0, 0:W - bw + 1:stride]
                k = np.nonzero(row >= target)[0]
                if len(k):
                    x0 = int(k[0]) * stride
                    best = (y0, x0, y0 + bh, x0 + bw)
                    best_area = bh * bw
                    found = True
                    break
            if found:
                break  # smaller widths for this height can't beat area order
    # local refinement: shrink edges while coverage holds
    y0, x0, y1, x1 = best
    improved = True
    while improved:
        improved = False
        for dy0, dx0, dy1, dx1 in ((1, 0, 0, 0), (0, 1, 0, 0),
                                   (0, 0, -1, 0), (0, 0, 0, -1)):
            ny0, nx0, ny1, nx1 = y0 + dy0, x0 + dx0, y1 + dy1, x1 + dx1
            if ny1 - ny0 >= 8 and nx1 - nx0 >= 8 and \
                    _box_sum(ii, ny0, nx0, ny1, nx1) >= target:
                y0, x0, y1, x1 = ny0, nx0, ny1, nx1
                improved = True
    return (y0, x0, y1, x1)


def region_fraction(region: Tuple[int, int, int, int], H: int, W: int) -> float:
    y0, x0, y1, x1 = region
    return (y1 - y0) * (x1 - x0) / float(H * W)


def rank_spans(density: np.ndarray, grain_frames: int,
               num_frames: int) -> List[Tuple[int, int]]:
    """Spans [(t0, t1)] ordered by estimated positive density (§6.1:
    prioritize spans likely rich in positives for the initial operator)."""
    order = np.argsort(-density, kind="stable")
    out = []
    for g in order:
        t0 = int(g) * grain_frames
        out.append((t0, min(t0 + grain_frames, num_frames)))
    return out
