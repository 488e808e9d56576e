"""Elastic scaling + straggler mitigation (design layer, unit-tested).

At 1000+ nodes, failures are routine. The policy implemented here:

  * ``plan_remesh(n_healthy)`` — given the surviving chip count, pick the
    largest valid (data, model) mesh that preserves the TP degree (model
    axis is sharding-correctness-critical; the data axis is elastic).
    Restart flow: restore host-side checkpoint -> build new mesh ->
    ``checkpoint.device_put_tree`` with the new shardings -> rescale the
    gradient-accumulation factor to keep the global batch constant.

  * ``StragglerMonitor`` — per-step host heartbeat deadlines from a
    rolling latency percentile; hosts that exceed ``k * p50`` twice in a
    row are flagged for eviction into the next remesh (on TPU pods, a
    straggling host stalls every collective, so eviction beats waiting).

The container has one host, so the flows are exercised by tests
(checkpoint -> shrink mesh -> restore -> step) rather than by killing
real nodes; every decision function is pure and covered.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    data: int
    model: int
    grad_accum: int           # microbatches to keep global batch constant
    dropped_chips: int


def plan_remesh(n_healthy: int, *, model_parallel: int = 16,
                global_batch: int = 256,
                base_data: int = 16) -> Optional[RemeshPlan]:
    """Largest data axis that fits the healthy chips, TP preserved."""
    if n_healthy < model_parallel:
        return None               # cannot even hold one model shard set
    data = n_healthy // model_parallel
    # data axis must divide the global batch for even sharding
    while data > 0 and global_batch % data != 0:
        data -= 1
    if data == 0:
        return None
    grad_accum = max(1, base_data // data)
    return RemeshPlan(data=data, model=model_parallel,
                      grad_accum=grad_accum,
                      dropped_chips=n_healthy - data * model_parallel)


class StragglerMonitor:
    def __init__(self, *, window: int = 32, k: float = 2.0,
                 strikes_to_evict: int = 2):
        self.window = window
        self.k = k
        self.strikes_to_evict = strikes_to_evict
        self._lat: Dict[str, Deque[float]] = {}
        self._strikes: Dict[str, int] = {}

    def record(self, host: str, step_seconds: float) -> None:
        self._lat.setdefault(host, deque(maxlen=self.window)).append(
            step_seconds)

    def _p50(self) -> float:
        all_lat = sorted(x for d in self._lat.values() for x in d)
        return all_lat[len(all_lat) // 2] if all_lat else 0.0

    def check(self) -> List[str]:
        """Returns hosts to evict (crossed the deadline twice running)."""
        p50 = self._p50()
        if p50 <= 0:
            return []
        deadline = self.k * p50
        evict = []
        for host, lat in self._lat.items():
            if lat and lat[-1] > deadline:
                self._strikes[host] = self._strikes.get(host, 0) + 1
            else:
                self._strikes[host] = 0
            if self._strikes.get(host, 0) >= self.strikes_to_evict:
                evict.append(host)
        return evict
