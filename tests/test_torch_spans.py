"""The port's span recorder (``repro_torch.spans``) and the spans of its
training step and MoE layer.

The recorder is on exactly while a ``torch.profiler`` records, keeps the
profiler's clock, and changes no bit of what the step computes. The
file imports neither JAX nor the JAX package; its ``cuda`` test runs on
the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_spans.py
"""
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as steps  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CPU = [torch.profiler.ProfilerActivity.CPU]
LAYERS = 2
BATCH, SEQ = 2, 64


@pytest.fixture(autouse=True)
def fresh_record():
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.clear()
    yield
    spans.clear()
    torch.set_num_threads(was)


def small_moe(device="cpu"):
    """granite-moe-3b-a800m cut to the benchmark's CPU test size (two
    layers, d 64, 8 experts of 96, top 2), trained as the benchmark
    trains it: float32 weights, bf16 compute, remat."""
    cfg = dataclasses.replace(
        get_smoke_config("granite-moe-3b-a800m"), num_layers=LAYERS,
        d_ff=96, head_dim=16, remat=True, compute_dtype="bfloat16")
    model = tf.init_model(cfg, torch.Generator().manual_seed(0), device,
                          trainable=True)
    return cfg, model


def batches(n):
    rng = np.random.default_rng(7)
    return [{"tokens": rng.integers(0, 256, (BATCH, SEQ)),
             "labels": rng.integers(0, 256, (BATCH, SEQ))}
            for _ in range(n)]


def train(n, traced, device="cpu", activities=CPU):
    """``n`` steps of the small model, under a profiler when ``traced``:
    (losses, the model)."""
    cfg, model = small_moe(device)
    step = steps.make_train_step(cfg, opt.AdamWConfig(warmup_steps=1))
    state = opt.init_opt_state(dict(model.named_parameters()))
    losses = []
    prof = torch.profiler.profile(activities=activities) if traced else None
    if prof is not None:
        prof.start()
    try:
        for b in batches(n):
            model, state, metrics = step(model, state, b)
            losses.append(metrics["loss"])
    finally:
        if prof is not None:
            prof.stop()
    return losses, model


def by_name(got, name):
    return [s for s in got if s.name == name]


def ancestors(s, ids):
    out = []
    while s.parent is not None:
        s = ids[s.parent]
        out.append(s.name)
    return out


def test_off_nothing_is_recorded_and_a_site_is_the_shared_null():
    assert spans.span("train.fwd", 3, "cpu") is spans.NULL
    assert not spans.NULL
    fn = spans.recompute("train.remat", "cpu")
    assert fn() is fn() and fn()[0] is spans.NULL and fn()[1] is spans.NULL
    with spans.span("train.fwd") as sp:
        sp.count(kept=1)
    train(1, traced=False)
    assert spans.taken() == []


def test_spans_record_their_parent_and_step_under_the_profiler():
    with torch.profiler.profile(activities=CPU):
        with spans.span("outer", 5) as a:
            with spans.span("inner") as b:
                b.count(rows=3, kept=torch.tensor(2))
            with spans.span("other", 9) as c:
                pass
        with spans.span("alone") as d:
            pass
    got = {s.name: s for s in spans.taken()}
    assert got["outer"] is a and a.parent is None and a.step == 5
    assert b.parent == a.id and b.step == 5
    assert b.counts == {"rows": 3, "kept": 2}
    assert c.parent == a.id and c.step == 9
    assert d.parent is None and d.step is None
    for s in (a, b, c, d):
        assert s.start_ns <= s.end_ns and s.device_ms is None
    assert a.start_ns <= b.start_ns <= b.end_ns <= c.start_ns <= a.end_ns
    spans.clear()
    assert spans.taken() == []


def test_a_span_closes_when_its_body_raises():
    with torch.profiler.profile(activities=CPU):
        with pytest.raises(RuntimeError):
            with spans.span("outer"):
                with spans.span("inner"):
                    raise RuntimeError("recompute stopped early")
        with spans.span("after") as after:
            pass
    assert [s.name for s in spans.taken()] == ["inner", "outer", "after"]
    assert after.parent is None


def test_spans_keep_the_profilers_clock():
    """Host times on ``time.time_ns``'s base: that of the harness's own
    spans (``portbench.trace.now_s``) and of the profiler's events, so a
    profiled op falls inside the span around it."""
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from portbench import trace
    x = torch.randn(128, 128)
    with torch.profiler.profile(activities=CPU) as prof:
        lo = trace.now_s()
        with spans.span("mm") as s:
            x @ x
        hi = trace.now_s()
    assert lo <= s.start_ns * 1e-9 <= s.end_ns * 1e-9 <= hi
    assert abs(s.start_ns - time.time_ns()) < 60e9
    mm = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "aten::mm"]
    assert mm
    for e in mm:
        assert s.start_ns <= e.start_ns() <= \
            e.start_ns() + e.duration_ns() <= s.end_ns


def test_a_steps_spans_under_remat():
    """A step records train.input, .fwd, .bwd, .optimizer once, a
    dispatch and a combine twice a layer (the forward and the recompute),
    a recompute and an MoE backward once a layer, each inside the spans
    it runs in, all under the step the optimizer starts from."""
    n = 2
    train(n, traced=True)
    got = spans.taken()
    ids = {s.id: s for s in got}
    for step in range(n):
        mine = [s for s in got if s.step == step]
        counts = {name: len(by_name(mine, name)) for name in (
            "train.input", "train.fwd", "train.bwd", "train.optimizer",
            "moe.dispatch", "moe.combine", "train.remat", "moe.bwd")}
        assert counts == {"train.input": 1, "train.fwd": 1, "train.bwd": 1,
                          "train.optimizer": 1, "moe.dispatch": 2 * LAYERS,
                          "moe.combine": 2 * LAYERS, "train.remat": LAYERS,
                          "moe.bwd": LAYERS}
        assert len(mine) == sum(counts.values())
        for name in ("train.input", "train.fwd", "train.bwd",
                     "train.optimizer"):
            assert by_name(mine, name)[0].parent is None
        for name in ("train.remat", "moe.bwd"):
            for s in by_name(mine, name):
                assert "train.bwd" in ancestors(s, ids)
        fwd = [ancestors(s, ids)[0] for s in by_name(mine, "moe.dispatch")
               + by_name(mine, "moe.combine")]
        assert sorted(fwd) == ["train.fwd"] * 2 * LAYERS + \
            ["train.remat"] * 2 * LAYERS
    assert len(got) == 16 * n


def test_kept_and_dropped_rows_add_up_to_every_routed_row():
    """Every dispatch of a step counts T·k routed rows and E·cap buffer
    rows; a dispatch's kept rows are each expert's load up to its
    capacity, computed here from the router alone, and kept and dropped
    rows add up to T·k."""
    train(1, traced=True)
    T, k, E = BATCH * SEQ, 2, 8
    cap = -(-T * k * 1.25 // E)
    for s in by_name(spans.taken(), "moe.dispatch"):
        assert s.counts["routed"] == T * k
        assert s.counts["rows"] == E * cap
        assert 0 < s.counts["kept"] <= min(T * k, E * cap)
    spans.clear()

    g = torch.Generator().manual_seed(1)
    d, f = 16, 8
    skew = torch.zeros(d, E)
    skew[:, 0] = 2.0                     # expert 0 takes more than its share
    params = {"router": torch.randn(d, E, generator=g) * 0.3 + skew,
              "wg": torch.randn(E, d, f, generator=g),
              "wu": torch.randn(E, d, f, generator=g),
              "wo": torch.randn(E, f, d, generator=g)}
    x = torch.randn(1, T, d, generator=g).abs()
    with torch.profiler.profile(activities=CPU):
        moe.moe_ffn(x, params, n_experts=E, top_k=k, capacity_factor=1.0)
    (s,) = by_name(spans.taken(), "moe.dispatch")
    _, _, _, gate_i = moe.route(x.reshape(T, d), params["router"], k)
    load = torch.bincount(gate_i.reshape(-1), minlength=E)
    cap = -(-T * k // E)
    dropped = int((load - cap).clamp_min(0).sum())
    assert dropped > 0
    assert s.counts["kept"] == int(load.clamp_max(cap).sum())
    assert s.counts["kept"] + dropped == s.counts["routed"] == T * k


def test_the_recorder_changes_no_bit_of_the_step():
    """Three steps' losses and the parameters after them are the same
    bits with the recorder on and off."""
    off_losses, off = train(3, traced=False)
    on_losses, on = train(3, traced=True)
    assert spans.taken()
    assert all(torch.equal(a, b) for a, b in zip(off_losses, on_losses))
    for (n, a), (_, b) in zip(off.named_parameters(), on.named_parameters()):
        assert torch.equal(a, b), n


@pytest.mark.cuda
def test_device_times_and_the_moe_backwards_self_time_on_the_card():
    """On the card each timed span has a device duration, and an MoE
    backward's self time, its duration less the recomputes it holds
    (autograd may run a block's recompute before or after the output's
    hook fires), is what is left of it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    activities = [torch.profiler.ProfilerActivity.CUDA]
    train(2, traced=True, device="cuda", activities=activities)
    got = spans.taken()
    ids = {s.id: s for s in got}
    for s in got:
        timed = s.name.startswith("train.") and s.name != "train.input" \
            or s.name == "moe.bwd"
        assert (s.device_ms is not None) == timed, s.name
        if timed:
            assert s.device_ms > 0
    bwd = by_name(got, "moe.bwd")
    assert len(bwd) == 2 * LAYERS
    for s in bwd:
        held = [c for c in got if c.name == "train.remat"
                and c.parent == s.id]
        inside = sum(c.device_ms for c in held)
        assert inside <= s.device_ms
        own = s.device_ms - inside
        assert 0 <= own <= s.device_ms
        for c in held:
            assert s.start_ns <= c.start_ns <= c.end_ns <= s.end_ns
    for s in by_name(got, "train.remat"):
        assert "train.bwd" in ancestors(s, ids)
