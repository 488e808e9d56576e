"""The harness's arithmetic, traffic, discovery by name and imports."""
import ast
import json
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench import harness, trace, traffic
from portbench.counts import model

PB = Path(__file__).resolve().parents[1]


def reader(name):
    return harness.reader(name)


def train_run(steps=7, t0=1.0, t_end=15.0, summary=None):
    cfg = harness.config(harness.manifest(), "h2o-danube-1.8b")
    rec = SimpleNamespace(steps=steps, tokens_per_step=4 * 4096, t0=t0,
                          t_end=t_end)
    return SimpleNamespace(record=rec, summary=summary, cfg=cfg,
                           traffic={"batch": 4, "seq_len": 4096},
                           device=SimpleNamespace(type="cuda"),
                           device_name="NVIDIA H100 80GB HBM3")


# -- metric arithmetic -------------------------------------------------------

def test_rates_are_the_whole_windows_work_over_the_whole_window():
    run = train_run()
    assert reader("train_tokens_per_s")(run) == \
        pytest.approx(7 * 4 * 4096 / 14.0)
    # the whole step's FLOPs over the whole window at the card's peak
    flops = 7 * model.train_flops(run.cfg, 4, 4096)
    assert reader("mfu.train")(run) == pytest.approx(100 * flops / 14.0 / 989e12)


def test_idle_share_comes_from_the_union_not_the_sum():
    device = [("a", 0.0, 4.0), ("b", 2.0, 6.0), ("c", 5.0, 7.0),
              ("d", 8.0, 9.0)]
    spans = [("train.step", 0.0, 7.5), ("train.read", 7.5, 9.5)]
    s = trace.summarize(device, spans, 0.0, 10.0)
    assert s.busy_s == pytest.approx(8.0)          # the sum would say 11
    assert s.by_name["b"] == pytest.approx(4.0)
    # idle [7, 8) and [9, 10), split over the spans open then
    assert s.idle_by_span == pytest.approx({"train.step": 0.5,
                                            "train.read": 1.0,
                                            "host": 0.5})
    assert reader("device_idle_share.train")(train_run(summary=s)) == \
        pytest.approx(20.0)


def test_readers_without_a_trace_give_nothing():
    run = train_run()
    run.device = SimpleNamespace(type="cpu")
    for name in ("device_idle_share.train", "roofline.flash_bwd.train",
                 "roofline.moe_gmm.train", "mfu.train"):
        assert reader(name)(run) is None


# -- traffic -----------------------------------------------------------------

def test_train_pool_repeats_and_every_row_differs():
    cfg = {"vocab_size": 1000}
    tr = {"batch": 2, "seq_len": 64, "pool": 4}
    a = traffic.train_pool(cfg, tr, 7)
    b = traffic.train_pool(cfg, tr, 7)
    c = traffic.train_pool(cfg, tr, 2 ** 33 + 7)
    assert all((x["tokens"] == y["tokens"]).all() for x, y in zip(a, b))
    assert any((x["tokens"] != y["tokens"]).any() for x, y in zip(a, c))
    assert [x["tokens"].shape for x in a] == [x["tokens"].shape for x in c]
    rows = {tuple(r) for x in a for r in x["tokens"]}
    assert len(rows) == 8
    assert (a[0]["labels"][:, :-1] == a[0]["tokens"][:, 1:]).all()


# -- discovery by name --------------------------------------------------------

def test_a_dropped_in_config_traffic_and_metric_are_found_by_name(
        tmp_path, monkeypatch):
    for d in ("configs", "traffic", "metrics", "limits"):
        (tmp_path / "portbench" / d).mkdir(parents=True)
    man = {"configs": [{"name": "m", "file": "portbench/configs/m.json"}],
           "workloads": [{"name": "m.t", "config": "m", "traffic": "t",
                          "chips": 1}],
           "end_to_end": [{"name": "setup_s", "unit": "s"},
                          {"name": "x_per_s", "unit": "x/s",
                           "workloads": ["other"]}],
           "per_layer": [{"name": "probe.new", "unit": "%", "moves": "setup_s",
                          "workloads": ["m.t"]},
                         {"name": "probe.all", "unit": "%", "moves": "setup_s"},
                         {"name": "probe.other", "unit": "%",
                          "moves": "x_per_s"}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    (tmp_path / "portbench/configs/m.json").write_text('{"hidden_size": 8}')
    (tmp_path / "portbench/traffic/t.json").write_text('{"driver": "train"}')
    (tmp_path / "portbench/metrics/probe.new.py").write_text(
        "def read(run):\n    return 42.0\n")
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    monkeypatch.setattr(harness, "HERE", tmp_path / "portbench")
    got = harness.manifest()
    assert harness.config(got, "m") == {"hidden_size": 8}
    assert harness.traffic("t") == {"driver": "train"}
    assert harness.reader("probe.new")(None) == 42.0
    assert [m["name"] for m in harness.metrics_of(got, "m.t", False)] == \
        ["setup_s"]
    assert [m["name"] for m in harness.metrics_of(got, "m.t", True)] == \
        ["probe.new", "probe.all"]
    with pytest.raises(KeyError):
        harness.cell(got, "nope")


def test_every_metric_and_cell_of_the_manifest_has_its_files():
    man = harness.manifest()
    for m in man["end_to_end"] + man["per_layer"]:
        assert (PB / "metrics" / f"{m['name']}.py").exists(), m["name"]
    for w in man["workloads"]:
        tr = harness.traffic(w["traffic"])
        assert (PB / "drivers" / f"{tr['driver']}.py").exists()
        assert set(harness.limits(w["name"]))
        assert harness.config(man, w["config"])["name"] == w["config"]


# -- imports -----------------------------------------------------------------

def imported(path: Path):
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.partition(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.partition(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", "") == "import_module" and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.add(node.args[0].value.partition(".")[0])
    return names


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(PB.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        bad = imported(f) & set(harness.FORBIDDEN)
        assert not bad, f"{f} imports {bad}"
    # whole names: the port's name begins with the JAX package's
    assert "repro_torch" not in harness.FORBIDDEN


def test_the_reference_imports_nothing_of_the_program():
    for f in sorted((PB / "reference").rglob("*.py")):
        assert "repro_torch" not in imported(f), f
        assert "repro_torch" not in f.read_text(), f


def test_forbidden_modules_are_found_by_whole_name(monkeypatch):
    import sys
    monkeypatch.setitem(sys.modules, "repro_torch_fake", object())
    assert harness.forbidden_loaded() == [] or \
        "repro_torch_fake" not in harness.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "repro.core", object())
    assert "repro" in harness.forbidden_loaded()


def test_spans_are_taken_only_when_traced():
    quiet, traced = trace.Spans(False), trace.Spans(True)
    t = trace.now_s()
    with quiet.span("x"), traced.span("train.step"):
        pass
    assert quiet.taken == []
    [(name, a, b)] = traced.taken
    assert name == "train.step" and t <= a <= b <= trace.now_s()
