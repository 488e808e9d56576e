"""Operator breeding + offline speed profiling (§7).

The cloud breeds a family of candidate operators per query: the paper's
grid (conv layers x channels x dense x input size) crossed with input
regions carved from the spatial-skew heatmap (full frame, 95%- and
80%-coverage k-enclosing regions). ~40 candidates by default; a reduced
family is available for CI-scale runs.

``profile`` attaches the camera-tier FPS to each arch (offline
profiling in the paper; the FLOPs->FPS cost model here).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.core import skew
from repro_torch.core.hardware import CameraTier, camera_fps
from repro_torch.core.operators import OperatorArch
from repro_torch.core.video import FRAME_H, FRAME_W


@dataclass(frozen=True)
class ProfiledOp:
    arch: OperatorArch
    fps: float                   # on-camera inference rate

    @property
    def name(self) -> str:
        return self.arch.name


def breed(heat: Optional[np.ndarray], *, full: bool = True) -> List[OperatorArch]:
    """Candidate operator family. ``full``: the paper's ~40; else ~12."""
    regions: List[Tuple[Optional[Tuple[int, int, int, int]], str]] = [
        (None, "full")]
    if heat is not None and heat.sum() > 0:
        r95 = skew.k_enclosing_region(heat, 0.95)
        r80 = skew.k_enclosing_region(heat, 0.80)
        if skew.region_fraction(r95, FRAME_H, FRAME_W) < 0.9:
            regions.append((r95, "r95"))
        if skew.region_fraction(r80, FRAME_H, FRAME_W) < \
                0.9 * skew.region_fraction(r95, FRAME_H, FRAME_W):
            regions.append((r80, "r80"))
    if full:
        grid = [(nl, c, d, s)
                for nl in (2, 3, 4, 5)
                for c, d in ((8, 16), (16, 32), (32, 64))
                for s in (25, 50, 100)]
        # 4 depths x 3 widths x 3 sizes = 36 per region; cap at ~40 total
        # by taking the full grid for the best region and a depth-diagonal
        # for the others.
        archs = []
        best_region = regions[-1]
        for (nl, c, d, s) in grid:
            reg, tag = best_region
            archs.append(OperatorArch(f"op_L{nl}c{c}s{s}_{tag}", nl, c, d, s,
                                      reg))
        for reg, tag in regions[:-1]:
            for (nl, c, d, s) in ((2, 8, 16, 25), (3, 16, 32, 50),
                                  (5, 32, 64, 100)):
                archs.append(OperatorArch(f"op_L{nl}c{c}s{s}_{tag}", nl, c, d,
                                          s, reg))
        return archs[:42]
    # reduced family (tests / CI)
    archs = []
    for reg, tag in regions:
        for (nl, c, d, s) in ((2, 8, 16, 25), (3, 16, 32, 50),
                              (4, 16, 32, 50), (5, 32, 64, 100)):
            archs.append(OperatorArch(f"op_L{nl}c{c}s{s}_{tag}", nl, c, d, s,
                                      reg))
    return archs


def profile(archs: List[OperatorArch], tier: CameraTier) -> List[ProfiledOp]:
    return [ProfiledOp(a, camera_fps(tier, a.flops)) for a in archs]
