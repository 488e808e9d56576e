"""Training: the step that the port's ``train_step.make_train_step``
returns, over one model and AdamW state.

Set-up builds the model from the seed (float32 parameters, the file's
compute type and remat, as ``launch/train.py`` runs it) and its AdamW
state, and drives them through the first ``first_steps`` steps on
distinct batches of the traffic's pool, through the same call and feed
as the window, in PyTorch's deterministic mode as the port's launcher
runs; it reads the program's state as it goes: each step's loss, each
parameter's first gradient as AdamW took it (from m after step 1:
m = (1 - b1) g), and after the last each parameter's distance from its
start (the start drawn again from the seed). The same objects go on to
the window, which runs steps on the pool in turn until ``seconds`` have
passed, the losses kept on the device, and ends in
``torch.cuda.synchronize()``.

The check runs the plain reference over the same first steps and
compares, by the worst parameter, three numbers (``train_numbers``).
"""
from __future__ import annotations

import copy
import math
import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, List

import torch

from portbench import port, traffic as TR
from portbench import weights as W
from portbench.reference import transformer as ref

# a parameter whose reference gradient is under this share of the median
# parameter's moves by round-off alone under AdamW: its change is not
# compared
STILL = 1e-3


@dataclass
class Record:
    t0: float
    t_end: float
    steps: int
    tokens_per_step: int
    losses: List[float]
    first: Dict = field(default_factory=dict)     # the set-up's readings
    attempted: int = 0
    failed: int = 0


class State:
    def __init__(self, model, opt_state, step, pool):
        self.model, self.opt_state, self.step, self.pool = \
            model, opt_state, step, pool
        self.done = 0
        self.first: Dict = {}

    def next(self, run):
        batch = self.pool[self.done % len(self.pool)]
        with run.span("train.step"):
            self.model, self.opt_state, metrics = self.step(
                self.model, self.opt_state, batch)
        self.done += 1
        return metrics["loss"]


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def deterministic():
    from repro_torch.train import train_step
    return train_step.deterministic()


@torch.no_grad()
def distances(run, model) -> Dict[str, float]:
    """Each parameter's distance from its start, the start drawn again
    from the seed a layer at a time."""
    params = dict(model.named_parameters())
    out, start, layer = {}, None, None
    for name, li, leaf in W.leaf_names(run.cfg):
        if li != layer:
            start = W.draw_top(run.cfg, run.seed, run.device) \
                if li == W.EMBED else \
                W.draw_layer(run.cfg, run.seed, li, run.device)
            layer = li
        p = params[name]
        out[name] = float((p.float() - start[leaf].reshape(p.shape)).norm())
    return out


def setup(run):
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step
    cfg, tr = run.cfg, run.traffic
    model = port.build_model(cfg, run.seed, run.device)
    run.mark("model")
    numbers = {k: v for k, v in cfg["optimizer"].items()
               if k in opt.AdamWConfig.__dataclass_fields__}
    ocfg = opt.AdamWConfig(**numbers)
    pool = run.extra.get("pool") or TR.train_pool(cfg, tr, run.seed)
    state = State(model, opt.init_opt_state(dict(model.named_parameters())),
                  train_step.make_train_step(model.cfg, ocfg), pool)
    run.mark("traffic")
    first = {"loss": [], "grad1": {}, "change": {}}
    with deterministic():
        for i in range(tr["first_steps"]):
            first["loss"].append(state.next(run))
            if i == 0:
                first["grad1"] = {n: float(m.norm()) / (1 - ocfg.b1)
                                  for n, m in state.opt_state.m.items()}
    first["loss"] = [float(x) for x in first["loss"]]
    run.mark("first_steps")
    first["change"] = distances(run, state.model)
    _sync(run.device)
    run.mark("distances")
    state.first = first
    return state


def window(run, state: State) -> Record:
    t0 = time.perf_counter()
    losses = []
    n0 = state.done
    with deterministic():
        while time.perf_counter() - t0 < run.seconds:
            losses.append(state.next(run))
        _sync(run.device)
    t_end = time.perf_counter()
    vals = torch.stack(losses).float().cpu().tolist()
    tr = run.traffic
    failed = sum(1 for v in vals if not math.isfinite(v))
    return Record(t0, t_end, state.done - n0, tr["batch"] * tr["seq_len"],
                  vals, state.first, attempted=len(vals), failed=failed)


def close(run, state: State) -> None:
    state.model = state.opt_state = state.step = None


def relative_gaps(prog: Dict[str, float], want: Dict[str, float],
                  leaves) -> float:
    """The worst leaf's |program's norm - reference's| over the larger of
    the reference's norm of that leaf and of the median leaf."""
    med = statistics.median(want[n] for n in leaves)
    return max(abs(prog[n] - want[n]) / max(want[n], med) for n in leaves)


def train_numbers(first: Dict, want: Dict) -> Dict[str, float]:
    """``loss_gap``: the worst step's |loss - reference's| / reference's;
    ``grad1_gap``: the first gradients' norms, ``change_gap``: the
    parameters' distances after the first steps, both by
    ``relative_gaps``, the change over the parameters whose reference
    gradient is not nought to rounding (``STILL``)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(first["loss"], want["loss"]))
    names = list(want["grad1"])
    left_out = set(still(want))
    moving = [n for n in names if n not in left_out]
    return {"loss_gap": loss,
            "grad1_gap": relative_gaps(first["grad1"], want["grad1"], names),
            "change_gap": relative_gaps(first["change"], want["change"],
                                        moving)}


def still(want: Dict) -> List[str]:
    """The parameters whose reference gradient is nought to rounding."""
    med = statistics.median(want["raw1"].values())
    return sorted(n for n, g in want["raw1"].items() if g < STILL * med)


def first_batches(run) -> List[Dict]:
    return TR.train_pool(run.cfg, run.traffic, run.seed)[
        :run.traffic["first_steps"]]


def check(run) -> Dict[str, float]:
    want = ref.train_readings(run.cfg, run.seed, run.device,
                              first_batches(run))
    run.extra["want"] = want
    run.extra["still"] = still(want)
    return train_numbers(run.record.first, want)


def control(run) -> Dict[str, float]:
    """The control's readings: the reference in fp8 put in the program's
    place, against the float32 reference of ``check``."""
    got = ref.train_readings(run.cfg, run.seed, run.device,
                             first_batches(run), precision="fp8")
    return train_numbers(got, run.extra["want"])


def faults(run) -> Dict[str, Dict[str, float]]:
    """Readings of the faults a one-chip training cell can have: half of
    each batch left out, the mean taken over the rest (the program run
    again from the seed on the first rows); a state left unchanged reads
    1 (``change_gap``) and needs no run."""
    half = copy.copy(run)
    b = run.traffic["batch"] // 2
    half.extra = {"pool": [{k: v[:b] for k, v in p.items()}
                           for p in first_batches(run)]}
    state = setup(half)
    close(half, state)
    return {"half_batch": train_numbers(state.first, run.extra["want"])}
