"""Synthetic video substrate with the statistical structure ZC² exploits.

The paper's 15 YouTube feeds are unavailable offline; this generator
reproduces what the technique depends on (DESIGN.md §8):
  * per-class long-term SPATIAL skew  — objects of a class concentrate in
    a scene-specific region (Fig. 4),
  * per-class long-term TEMPORAL skew — occurrences cluster in time-of-day
    bands (Fig. 5),
  * class-specific object size/appearance, day/night noise.

A video is a deterministic function of its spec: object *events*
(class, t0, duration, position, size) are sampled once from the seed;
``render_frames`` rasterizes any frame index on demand (nothing is
stored), so 48 simulated hours cost no memory.

Ground truth (presence/count/boxes per frame) comes from the event list
and is what the detector oracle corrupts per accuracy tier.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

FRAME_H = 96
FRAME_W = 96


@dataclass(frozen=True)
class ClassSpec:
    """One object class in a scene."""
    name: str
    rate_per_hour: float          # mean event arrivals per hour
    duration_s: Tuple[float, float]   # (min, max) seconds on screen
    region_center: Tuple[float, float]  # fractional (y, x) of spatial skew
    region_sd: Tuple[float, float]      # fractional gaussian sd (spatial skew)
    size: Tuple[int, int]         # (min, max) box side in pixels
    color: Tuple[int, int, int]
    hour_profile: Tuple[float, ...] = tuple([1.0] * 24)  # temporal skew
    max_concurrent: int = 6


@dataclass(frozen=True)
class VideoSpec:
    name: str
    seed: int
    classes: Tuple[ClassSpec, ...]
    hours: float = 6.0
    fps: float = 1.0
    night: bool = False           # heavier sensor noise
    bg_complexity: float = 0.5    # background texture amplitude

    @property
    def num_frames(self) -> int:
        return int(self.hours * 3600 * self.fps)


@dataclass
class Event:
    cls: str
    t0: float
    t1: float
    y: float                      # center, pixels
    x: float
    size: int
    wobble: float                 # px/s drift


class Video:
    """Deterministic synthetic video: events + on-demand renderer."""

    def __init__(self, spec: VideoSpec):
        self.spec = spec
        rng = np.random.default_rng(spec.seed)
        self.events: List[Event] = []
        total_s = spec.hours * 3600
        for cs in spec.classes:
            # thinning over the hour profile for temporal skew
            prof = np.asarray(cs.hour_profile, np.float64)
            prof = prof / prof.mean()
            n = rng.poisson(cs.rate_per_hour * spec.hours)
            t0s = rng.uniform(0, total_s, size=n)
            hours = ((t0s / 3600) % 24).astype(int)
            keep = rng.uniform(0, 1, size=n) < prof[hours] / max(prof.max(), 1e-9)
            t0s = t0s[keep]
            for t0 in t0s:
                dur = rng.uniform(*cs.duration_s)
                y = np.clip(rng.normal(cs.region_center[0], cs.region_sd[0]),
                            0.02, 0.98) * FRAME_H
                x = np.clip(rng.normal(cs.region_center[1], cs.region_sd[1]),
                            0.02, 0.98) * FRAME_W
                size = int(rng.integers(cs.size[0], cs.size[1] + 1))
                self.events.append(Event(cs.name, t0, t0 + dur, y, x, size,
                                         rng.uniform(-0.15, 0.15)))
        self.events.sort(key=lambda e: e.t0)
        self._starts = np.array([e.t0 for e in self.events])
        self._ends = np.array([e.t1 for e in self.events])
        self._bg = self._make_background(rng)

    # -- ground truth -------------------------------------------------------

    def frame_time(self, idx) -> np.ndarray:
        return np.asarray(idx, np.float64) / self.spec.fps

    def events_at(self, idx: int) -> List[Event]:
        t = float(idx) / self.spec.fps
        sel = (self._starts <= t) & (self._ends > t)
        return [self.events[i] for i in np.nonzero(sel)[0]]

    def gt_count(self, idx: int, cls: str) -> int:
        return sum(1 for e in self.events_at(idx) if e.cls == cls)

    def gt_present(self, idx: int, cls: str) -> bool:
        return self.gt_count(idx, cls) > 0

    def gt_boxes(self, idx: int, cls: Optional[str] = None):
        """[(cls, y0, x0, y1, x1)] for frame idx."""
        t = float(idx) / self.spec.fps
        out = []
        for e in self.events_at(idx):
            if cls is not None and e.cls != cls:
                continue
            drift = e.wobble * (t - e.t0)
            y, x = e.y + drift, e.x + drift * 0.3
            h = e.size / 2
            y0, x0 = max(0, y - h), max(0, x - h)
            y1, x1 = min(FRAME_H, y + h), min(FRAME_W, x + h)
            if y1 <= y0 or x1 <= x0:       # drifted out of view
                continue
            out.append((e.cls, y0, x0, y1, x1))
        return out

    def gt_present_vec(self, idxs: np.ndarray, cls: str) -> np.ndarray:
        ts = np.asarray(idxs, np.float64) / self.spec.fps
        sel = np.array([e.cls == cls for e in self.events], bool)
        if not sel.any():
            return np.zeros(len(ts), bool)
        s, e = self._starts[sel], self._ends[sel]
        return ((s[None, :] <= ts[:, None]) & (e[None, :] > ts[:, None])).any(1)

    def gt_count_vec(self, idxs: np.ndarray, cls: str) -> np.ndarray:
        ts = np.asarray(idxs, np.float64) / self.spec.fps
        sel = np.array([e.cls == cls for e in self.events], bool)
        if not sel.any():
            return np.zeros(len(ts), np.int32)
        s, e = self._starts[sel], self._ends[sel]
        return ((s[None, :] <= ts[:, None]) & (e[None, :] > ts[:, None])).sum(1).astype(np.int32)

    # -- rendering ----------------------------------------------------------

    def _make_background(self, rng) -> np.ndarray:
        base = rng.uniform(60, 120, size=3)
        yy, xx = np.mgrid[0:FRAME_H, 0:FRAME_W].astype(np.float64)
        tex = (np.sin(yy / 9.0) + np.cos(xx / 13.0) +
               0.5 * np.sin((xx + yy) / 7.0))
        img = base[None, None, :] + self.spec.bg_complexity * 22 * tex[..., None]
        return np.clip(img, 0, 255)

    def render_frames(self, idxs: Sequence[int]) -> np.ndarray:
        """(N, H, W, 3) float32 in [0,1]. Deterministic per frame index."""
        idxs = np.asarray(idxs, np.int64)
        out = np.empty((len(idxs), FRAME_H, FRAME_W, 3), np.float32)
        day_amp = 1.0
        for i, idx in enumerate(idxs):
            t = float(idx) / self.spec.fps
            hour = (t / 3600) % 24
            # day/night brightness cycle
            lum = 0.55 + 0.45 * np.sin((hour - 6) / 24 * 2 * np.pi) * day_amp
            lum = max(lum, 0.25)
            img = self._bg * lum
            for e in self.events_at(int(idx)):
                drift = e.wobble * (t - e.t0)
                y, x = e.y + drift, e.x + drift * 0.3
                h = e.size / 2
                y0, y1 = int(max(0, y - h)), int(min(FRAME_H, y + h))
                x0, x1 = int(max(0, x - h)), int(min(FRAME_W, x + h))
                if y1 <= y0 or x1 <= x0:
                    continue
                color = np.array(
                    next(c.color for c in self.spec.classes if c.name == e.cls),
                    np.float64) * lum
                img = img.copy() if img is self._bg else img
                img[y0:y1, x0:x1] = 0.25 * img[y0:y1, x0:x1] + 0.75 * color
            frng = np.random.default_rng((self.spec.seed * 1_000_003 + int(idx)) & 0x7FFFFFFF)
            noise_sd = 14.0 if self.spec.night else 6.0
            img = img + frng.normal(0, noise_sd, size=img.shape)
            out[i] = np.clip(img, 0, 255) / 255.0
        return out

    def render_crops(self, idxs, region, out_size: int) -> np.ndarray:
        """Crop ``region`` = (y0, x0, y1, x1) px and resize to out_size^2."""
        frames = self.render_frames(idxs)
        y0, x0, y1, x1 = [int(v) for v in region]
        crop = frames[:, y0:y1, x0:x1, :]
        return _resize_batch(crop, out_size)


def _resize_batch(imgs: np.ndarray, out: int) -> np.ndarray:
    """Nearest-neighbor batch resize (cheap; operators are robust to it)."""
    n, h, w, c = imgs.shape
    ys = np.clip((np.arange(out) + 0.5) * h / out, 0, h - 1).astype(int)
    xs = np.clip((np.arange(out) + 0.5) * w / out, 0, w - 1).astype(int)
    return imgs[:, ys][:, :, xs]


# ---------------------------------------------------------------------------
# The 15-scene corpus (Table 2 analogues, disparate skews)
# ---------------------------------------------------------------------------

def _cls(name, rate, center, sd, size, color, hours=None, dur=(20, 90)):
    prof = tuple(hours) if hours is not None else tuple([1.0] * 24)
    return ClassSpec(name, rate, dur, center, sd, size, color, prof)


def _day_profile(peak: int, width: float = 4.0):
    h = np.arange(24, dtype=np.float64)
    d = np.minimum(np.abs(h - peak), 24 - np.abs(h - peak))
    return tuple(np.exp(-0.5 * (d / width) ** 2) + 0.05)


def corpus(hours: float = 6.0) -> Dict[str, VideoSpec]:
    """15 scenes mirroring Table 2: (name, queried class) with diverse
    spatial skew strength, rarity, object size, and noise."""
    V = {}
    V["JacksonH"] = VideoSpec("JacksonH", 11, hours=hours, classes=(
        _cls("car", 260, (0.62, 0.5), (0.10, 0.22), (10, 22), (200, 40, 40),
             _day_profile(14, 6)),
        _cls("person", 60, (0.75, 0.3), (0.08, 0.12), (6, 12), (40, 200, 60)),))
    V["JacksonT"] = VideoSpec("JacksonT", 12, hours=hours, night=True, classes=(
        _cls("car", 90, (0.55, 0.5), (0.08, 0.25), (10, 20), (210, 60, 40),
             _day_profile(22, 4)),))
    V["Banff"] = VideoSpec("Banff", 13, hours=hours, classes=(
        _cls("bus", 26, (0.48, 0.62), (0.07, 0.10), (16, 30), (230, 180, 40),
             _day_profile(13, 5), dur=(25, 80)),
        _cls("car", 200, (0.55, 0.45), (0.12, 0.25), (9, 18), (150, 60, 60)),))
    V["Mierlo"] = VideoSpec("Mierlo", 14, hours=hours, classes=(
        _cls("truck", 14, (0.42, 0.5), (0.05, 0.30), (18, 34), (90, 90, 220),
             _day_profile(11, 5), dur=(15, 50)),))
    V["Miami"] = VideoSpec("Miami", 15, hours=hours, classes=(
        _cls("car", 320, (0.58, 0.5), (0.10, 0.28), (10, 20), (220, 60, 50),
             _day_profile(17, 7)),))
    V["Ashland"] = VideoSpec("Ashland", 16, hours=hours, classes=(
        # large trains covering 4/5 of the frame: weak spatial skew
        _cls("train", 7, (0.5, 0.5), (0.20, 0.35), (46, 76), (120, 120, 130),
             _day_profile(12, 8), dur=(40, 120)),))
    V["Shibuya"] = VideoSpec("Shibuya", 17, hours=hours, classes=(
        _cls("bus", 40, (0.40, 0.55), (0.08, 0.14), (15, 28), (60, 180, 60),
             _day_profile(12, 7)),
        _cls("person", 500, (0.8, 0.5), (0.06, 0.3), (5, 10), (200, 200, 70)),))
    V["Chaweng"] = VideoSpec("Chaweng", 18, hours=hours, classes=(
        # small bicycles in a 1/8-of-frame region: strongest spatial skew
        _cls("bicycle", 34, (0.70, 0.25), (0.035, 0.05), (6, 11), (40, 160, 220),
             _day_profile(18, 5)),))
    V["Lausanne"] = VideoSpec("Lausanne", 19, hours=hours, classes=(
        _cls("car", 55, (0.5, 0.68), (0.08, 0.12), (10, 18), (200, 80, 60),
             _day_profile(9, 4)),
        _cls("person", 220, (0.62, 0.4), (0.1, 0.25), (6, 11), (80, 200, 80)),))
    V["Venice"] = VideoSpec("Venice", 20, hours=hours, classes=(
        _cls("person", 420, (0.66, 0.5), (0.09, 0.26), (6, 12), (210, 190, 90),
             _day_profile(15, 6)),))
    V["Oxford"] = VideoSpec("Oxford", 21, hours=hours, classes=(
        _cls("bus", 30, (0.45, 0.52), (0.06, 0.11), (16, 30), (200, 40, 40),
             _day_profile(10, 6)),
        _cls("car", 140, (0.5, 0.5), (0.1, 0.25), (9, 16), (120, 120, 170)),))
    V["Whitebay"] = VideoSpec("Whitebay", 22, hours=hours, classes=(
        _cls("person", 70, (0.55, 0.45), (0.12, 0.20), (7, 13), (230, 170, 120),
             _day_profile(14, 4)),))
    V["CoralReef"] = VideoSpec("CoralReef", 23, hours=hours, classes=(
        _cls("person", 45, (0.6, 0.5), (0.15, 0.22), (9, 16), (220, 200, 160),
             _day_profile(13, 3)),))
    V["BoatHouse"] = VideoSpec("BoatHouse", 24, hours=hours, classes=(
        # indoor retail: persons in the aisle (Fig. 4b analogue)
        _cls("person", 120, (0.68, 0.35), (0.05, 0.08), (9, 16), (210, 160, 130),
             _day_profile(12, 4)),))
    V["Eagle"] = VideoSpec("Eagle", 25, hours=hours, classes=(
        # wildlife: rare, localized (nest)
        _cls("eagle", 10, (0.30, 0.55), (0.04, 0.05), (8, 15), (150, 120, 80),
             _day_profile(7, 3), dur=(60, 300)),))
    return V


# Queried class per video (Table 2 column 3)
QUERY_CLASS = {
    "JacksonH": "car", "JacksonT": "car", "Banff": "bus", "Mierlo": "truck",
    "Miami": "car", "Ashland": "train", "Shibuya": "bus",
    "Chaweng": "bicycle", "Lausanne": "car", "Venice": "person",
    "Oxford": "bus", "Whitebay": "person", "CoralReef": "person",
    "BoatHouse": "person", "Eagle": "eagle",
}
