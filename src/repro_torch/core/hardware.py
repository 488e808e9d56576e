"""Camera / cloud / network cost models (§2.1, Table 3a).

Wall-clock *time* in a query execution is simulated from these models
(the container has no Rpi3 or radio); operator *accuracy* is real PyTorch.
Every paper claim we validate is a ratio of simulated times, so the
calibration below (YOLOv3 at ~0.1 FPS on Rpi3, 1 MB/s uplink, operators
at 27x-1000x realtime) is what matters, and it matches §2.1/§8.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CameraTier:
    name: str
    effective_flops: float       # sustained NN flops/s on this camera
    dram_gb: float


# Calibration: YOLOv3 ~= 65 GFLOPs/frame; Rpi3 runs it at ~0.1 FPS ([6,70])
RPI3 = CameraTier("rpi3", 6.5e9, 1.0)
ODROID = CameraTier("odroid", 13.0e9, 2.0)
# "a few hundred dollars" high-end camera (§8.4 brawny-camera study)
BRAWNY = CameraTier("brawny", 39.0e9, 4.0)

CAMERA_TIERS = {t.name: t for t in (RPI3, ODROID, BRAWNY)}


@dataclass(frozen=True)
class DetectorModel:
    name: str
    flops: float                 # per 96x96-equivalent frame (scaled)
    accuracy: float              # oracle detection quality in [0,1]
    map_score: float             # paper-reported mAP, for reporting


# mAP ordering from §8: Yv3 57.9 > Yv2 48.1 > YTiny 33.1
YOLO_V3 = DetectorModel("yolov3", 65e9, 0.95, 57.9)
YOLO_V2 = DetectorModel("yolov2", 30e9, 0.82, 48.1)
YOLO_TINY = DetectorModel("yolov3-tiny", 5.6e9, 0.58, 33.1)

DETECTORS = {d.name: d for d in (YOLO_V3, YOLO_V2, YOLO_TINY)}


@dataclass(frozen=True)
class NetworkModel:
    uplink_bytes_per_s: float = 1_000_000.0    # 1 MB/s default [51]
    frame_bytes: float = 60_000.0              # ~720p JPEG frame
    thumbnail_bytes: float = 5_000.0           # 100x100 landmark thumbnail
    tag_bytes: float = 8.0                     # one-bit tag + framing

    @property
    def frame_upload_fps(self) -> float:
        return self.uplink_bytes_per_s / self.frame_bytes

    def upload_time(self, n_frames: float = 0, n_thumbs: float = 0,
                    n_tags: float = 0, extra_bytes: float = 0) -> float:
        b = (n_frames * self.frame_bytes + n_thumbs * self.thumbnail_bytes +
             n_tags * self.tag_bytes + extra_bytes)
        return b / self.uplink_bytes_per_s


@dataclass(frozen=True)
class CloudModel:
    """§2.3 scope: the cloud is not a limiting factor for detection, but
    operator (re)training takes real time (§8: 5-45 s per operator)."""
    train_seconds_per_mflop_param: float = 2.0   # ~5-45s over our op family
    ship_bytes_per_s: float = 1_000_000.0        # operator push (downlink)

    def train_time(self, op_params: int, n_samples: int) -> float:
        # 5-45 s across the family, growing with op size and sample count
        base = 3.0 + self.train_seconds_per_mflop_param * op_params / 1e6
        return base * min(1.0 + n_samples / 10_000, 3.0)

    def ship_time(self, op_bytes: float) -> float:
        return op_bytes / self.ship_bytes_per_s


def camera_fps(tier: CameraTier, flops_per_frame: float) -> float:
    return tier.effective_flops / max(flops_per_frame, 1.0)


def landmark_interval(tier: CameraTier, detector: DetectorModel,
                      video_fps: float) -> int:
    """Smallest landmark interval this camera sustains in real time:
    one detector pass per interval while capturing at video_fps."""
    det_fps = camera_fps(tier, detector.flops)
    return max(1, int(round(video_fps / det_fps)))
