"""The readers of the program's spans (``portbench/program_spans.py`` and
the eight metrics on it) over synthetic spans: the window, the division
by the window's steps, self time, and nothing to read."""
import sys
from types import SimpleNamespace

import pytest

from portbench import harness, trace

MS = 1_000_000                     # ns
READERS = ("train.input_wait_ms", "train.fwd_ms", "train.bwd_ms",
           "train.remat_ms", "train.optimizer_ms",
           "model.moe_dispatch_host_ms", "model.moe_bwd_ms",
           "model.moe_pad_share")


def sp(id, name, start_ms, end_ms, parent=None, device_ms=None, **counts):
    return SimpleNamespace(id=id, name=name, parent=parent, step=0,
                           start_ns=int((1e6 + start_ms) * MS),
                           end_ns=int((1e6 + end_ms) * MS),
                           device_ms=device_ms, counts=counts)


def step_spans(base, t, dev=True):
    """One step's spans from ``t`` ms: ids from ``base``; device times
    where ``dev``."""
    d = (lambda ms: ms) if dev else (lambda ms: None)
    return [
        sp(base, "train.input", t, t + 2),
        sp(base + 1, "train.fwd", t + 2, t + 40, device_ms=d(30.0)),
        sp(base + 2, "moe.dispatch", t + 3, t + 8, base + 1,
           routed=64, kept=60, rows=80),
        sp(base + 3, "moe.combine", t + 9, t + 11, base + 1),
        sp(base + 4, "train.bwd", t + 40, t + 100, device_ms=d(55.0)),
        sp(base + 5, "moe.bwd", t + 41, t + 70, base + 4,
           device_ms=d(25.0)),
        sp(base + 6, "train.remat", t + 42, t + 60, base + 5,
           device_ms=d(12.0)),
        sp(base + 7, "moe.dispatch", t + 43, t + 47, base + 6,
           routed=64, kept=60, rows=80),
        sp(base + 8, "moe.combine", t + 48, t + 49, base + 6),
        sp(base + 9, "train.remat", t + 71, t + 80, base + 4,
           device_ms=d(8.0)),
        sp(base + 10, "train.optimizer", t + 100, t + 110,
           device_ms=d(9.0)),
    ]


class Recorder:
    """``repro_torch.spans``' reading functions over given spans."""

    def __init__(self, got):
        self.got, self.reads = got, 0

    def taken(self):
        self.reads += 1
        return list(self.got)

    def clear(self):
        self.got = []


def run_over(monkeypatch, got, window=(1e3, 1e3 + 0.5), steps=2):
    """A run whose window is ``window`` (s) and covers ``steps`` steps,
    the program's recorder holding ``got``."""
    import repro_torch
    rec = Recorder(got)
    monkeypatch.setitem(sys.modules, "repro_torch.spans", rec)
    monkeypatch.setattr(repro_torch, "spans", rec, raising=False)
    spans = trace.Spans(True)
    spans.taken.append((trace.WINDOW, *window))
    run = SimpleNamespace(spans=spans, record=SimpleNamespace(steps=steps),
                          extra={}, device=SimpleNamespace(type="cuda"))
    return run, rec


def read(name, run):
    return harness.reader(name)(run)


def test_the_window_the_steps_and_each_quantity(monkeypatch):
    # two steps inside the window (1000 s + [0, 500) ms); one before it
    # and one after it, left out
    got = step_spans(0, -200) + step_spans(100, 10) + step_spans(200, 200) \
        + step_spans(300, 600)
    run, rec = run_over(monkeypatch, got)
    assert read("train.input_wait_ms", run) == pytest.approx(2.0)
    assert read("train.fwd_ms", run) == pytest.approx(30.0)
    assert read("train.bwd_ms", run) == pytest.approx(55.0)
    assert read("train.remat_ms", run) == pytest.approx(20.0)
    assert read("train.optimizer_ms", run) == pytest.approx(9.0)
    # forward and recompute: (5 + 2 + 4 + 1) ms a step
    assert read("model.moe_dispatch_host_ms", run) == pytest.approx(12.0)
    # 25 ms less the 12 ms recompute it holds; the other recompute is
    # not its child
    assert read("model.moe_bwd_ms", run) == pytest.approx(13.0)
    # the forward dispatches only: 1 - 120 / 160
    assert read("model.moe_pad_share", run) == pytest.approx(25.0)
    assert rec.reads == 1                       # read once a run


def test_the_pad_share_sums_before_it_divides(monkeypatch):
    got = [sp(0, "moe.dispatch", 1, 2, routed=64, kept=64, rows=80),
           sp(1, "moe.dispatch", 3, 4, routed=64, kept=16, rows=40)]
    run, _ = run_over(monkeypatch, got)
    assert read("model.moe_pad_share", run) == pytest.approx(
        100 * (1 - 80 / 120))


def test_device_metrics_give_nothing_on_the_cpu(monkeypatch):
    run, _ = run_over(monkeypatch, step_spans(0, 10, dev=False))
    for name in ("train.fwd_ms", "train.bwd_ms", "train.remat_ms",
                 "train.optimizer_ms", "model.moe_bwd_ms"):
        assert read(name, run) is None, name
    # the host's clock and the counts are there all the same
    assert read("train.input_wait_ms", run) == pytest.approx(1.0)


def test_nothing_recorded_or_no_recorder_gives_nothing(monkeypatch):
    run, _ = run_over(monkeypatch, [])
    for name in READERS:
        assert read(name, run) is None, name
    # a program without the recorder (a checkout older than it): the
    # import fails and every reader gives None
    run, _ = run_over(monkeypatch, step_spans(0, 10))
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    import repro_torch
    monkeypatch.delattr(repro_torch, "spans", raising=False)
    for name in READERS:
        assert read(name, run) is None, name
    # an untraced run has no window span
    run, _ = run_over(monkeypatch, step_spans(0, 10))
    run.spans.taken.clear()
    assert read("train.fwd_ms", run) is None


def test_the_readers_are_the_manifests():
    man = harness.manifest()
    mine = {m["name"]: m for m in man["per_layer"] if m["name"] in READERS}
    assert set(mine) == set(READERS)
    for m in mine.values():
        assert m["moves"] == "train_tokens_per_s"
        assert m["layer"] == ("LM model" if m["name"].startswith("model.")
                              else "trainer")
        granite = ["granite-moe-3b-a800m.train_2x4096"]
        assert m["workloads"] == (granite if m["layer"] == "LM model" else
                                  granite + ["h2o-danube-1.8b.train_4x4096"])
