"""The port's training substrate against the JAX package's.

``tests/test_substrate.py``'s optimizer tests (a quadratic, clipping, the
schedule, decay on matrices only) run on the same trees through both
packages' AdamW and must agree within 1e-6; its six checkpoint tests run
on the port's checkpoints of torch tensors, plus a bfloat16 round trip
(stored as its 16 bits); ``TokenPipeline.batch_at`` and the elastic
plans equal the JAX package's; and the port's launcher
(``repro_torch.launch.train``) on xlstm-125m's smoke config on the CPU:
6 steps straight against 3 steps stopped by SIGTERM (which leaves a
checkpoint) and ``--resume auto`` for the other 3, bit for bit.
"""
import contextlib
import json
import os
import signal

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.train import data as jdata  # noqa: E402
from repro.train import elastic as jelastic  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.train import checkpoint as ckpt  # noqa: E402
from repro_torch.train import data as data_mod  # noqa: E402
from repro_torch.train import elastic  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402

TOL = 1e-6


def _both(cfg_kw, params, grads_fn, steps):
    """``steps`` AdamW steps of the same tree in both packages -> (port
    params, JAX params, port metrics, JAX metrics)."""
    jcfg, cfg = jopt.AdamWConfig(**cfg_kw), opt.AdamWConfig(**cfg_kw)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.tensor(v) for k, v in params.items()}
    js, ts = jopt.init_opt_state(jp), opt.init_opt_state(tp)
    for _ in range(steps):
        jg = {k: jnp.asarray(v) for k, v in grads_fn(
            {k: np.asarray(a) for k, a in jp.items()}).items()}
        tg = {k: torch.tensor(v) for k, v in grads_fn(
            {k: t.numpy() for k, t in tp.items()}).items()}
        jp, js, jm = jopt.apply_updates(jcfg, jp, jg, js)
        tp, ts, tm = opt.apply_updates(cfg, tp, tg, ts)
    assert ts.step == int(js.step) == steps
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=TOL, atol=TOL)
    return tp, jp, tm, jm


def test_adamw_optimizes_quadratic():
    params = {"w": np.array([3.0, -2.0], np.float32),
              "b": np.array(1.5, np.float32)}
    tp, _, _, _ = _both(dict(lr=0.1, warmup_steps=0, total_steps=200,
                             weight_decay=0.0, clip_norm=100.0), params,
                        lambda p: {k: 2 * v for k, v in p.items()}, 150)
    loss = float((tp["w"] ** 2).sum() + tp["b"] ** 2)
    assert loss < 1e-3 * (9 + 4 + 2.25)


def test_adamw_grad_clipping():
    _, _, tm, jm = _both(dict(lr=1.0, warmup_steps=0, clip_norm=1.0,
                              weight_decay=0.0),
                         {"w": np.zeros(4, np.float32)},
                         lambda p: {"w": np.full(4, 100.0, np.float32)}, 1)
    assert float(tm["grad_norm"]) == pytest.approx(200.0)
    assert float(tm["grad_norm"]) == float(jm["grad_norm"])


def test_schedule_warmup_and_cosine():
    kw = dict(lr=1e-3, warmup_steps=10, total_steps=100, min_lr_frac=0.1)
    jcfg, cfg = jopt.AdamWConfig(**kw), opt.AdamWConfig(**kw)
    lrs = [float(opt.schedule(cfg, s)) for s in range(0, 111)]
    # float32 within an ulp or two: XLA's cos and torch's differ in the
    # last bit at some steps
    assert lrs == pytest.approx([float(jopt.schedule(jcfg, jnp.array(s)))
                                 for s in range(0, 111)], rel=1e-6, abs=0)
    assert lrs[0] == 0.0 and lrs[5] == pytest.approx(0.5e-3)
    assert lrs[10] == pytest.approx(1e-3)
    assert lrs[100] == pytest.approx(0.1e-3, rel=1e-3)
    assert all(a >= b - 1e-12 for a, b in zip(lrs[10:101], lrs[11:101]))


def test_weight_decay_matrices_only():
    tp, _, _, _ = _both(dict(lr=0.1, warmup_steps=0, weight_decay=0.5,
                             clip_norm=1e9),
                        {"mat": np.ones((2, 2), np.float32),
                         "vec": np.ones((2,), np.float32)},
                        lambda p: {k: np.zeros_like(v) for k, v in p.items()},
                        1)
    assert float(tp["mat"][0, 0]) < 1.0
    assert float(tp["vec"][0]) == pytest.approx(1.0)


def test_decay_mask_overrides_the_dimension_rule():
    """A model's ``decay_mask`` decides: a vector marked for decay decays,
    a matrix marked not to does not."""
    cfg = opt.AdamWConfig(lr=0.1, warmup_steps=0, weight_decay=0.5,
                          clip_norm=1e9)
    p = {"mat": torch.ones(2, 2), "vec": torch.ones(2)}
    g = {k: torch.zeros_like(v) for k, v in p.items()}
    opt.apply_updates(cfg, p, g, opt.init_opt_state(p),
                      decay={"mat": False, "vec": True})
    assert float(p["mat"][0, 0]) == 1.0 and float(p["vec"][0]) < 1.0


# -- checkpoints ---------------------------------------------------------------

def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(4, 3, generator=g),
            "nested": {"b": torch.arange(5, dtype=torch.int32)},
            "scalar": torch.tensor(7.5)}


def test_checkpoint_roundtrip(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 3, tree, extra={"data_step": 42})
    out = ckpt.restore_latest(str(tmp_path), tree)
    assert out is not None
    restored, manifest = out
    assert manifest["step"] == 3
    assert manifest["extra"]["data_step"] == 42
    assert torch.equal(restored["a"], tree["a"])
    assert torch.equal(restored["nested"]["b"], tree["nested"]["b"])
    assert restored["nested"]["b"].dtype == torch.int32
    assert float(restored["scalar"]) == 7.5


def test_checkpoint_rotation(tmp_path):
    tree = _tree()
    for s in range(6):
        ckpt.save(str(tmp_path), s, tree, keep=3)
    dirs = sorted(p.name for p in tmp_path.iterdir() if p.is_dir())
    assert dirs == [f"step_{s:09d}" for s in (3, 4, 5)]
    assert (tmp_path / "LATEST").read_text() == "step_000000005"


def test_checkpoint_no_tmp_left_behind(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    assert not list(tmp_path.glob("*.tmp"))


def test_checkpoint_corrupt_fallback(tmp_path):
    """Crash-during-commit drill: newest checkpoint truncated -> restore
    falls back to the previous valid one."""
    tree = _tree()
    ckpt.save(str(tmp_path), 1, tree)
    ckpt.save(str(tmp_path), 2, tree)
    victim = next((tmp_path / "step_000000002").glob("*.npy"))
    victim.unlink()
    out = ckpt.restore_latest(str(tmp_path), tree)
    assert out is not None and out[1]["step"] == 1


def test_checkpoint_structure_mismatch_fails(tmp_path):
    ckpt.save(str(tmp_path), 1, _tree())
    assert ckpt.restore_latest(str(tmp_path),
                               {"different": torch.zeros(3)}) is None
    with pytest.raises(ValueError, match="structure mismatch"):
        ckpt._load_dir(tmp_path / "step_000000001", {"different": 0})


def test_checkpoint_restore_empty(tmp_path):
    assert ckpt.restore_latest(str(tmp_path / "nope"), _tree()) is None


def test_checkpoint_bf16_and_optimizer_state(tmp_path):
    """bfloat16 leaves go to disk as their 16 bits, with ``bfloat16`` in
    the manifest, and come back bit for bit; an ``OptState`` keeps its
    step and its moments under ``opt/step``, ``opt/m/...``."""
    g = torch.Generator().manual_seed(1)
    params = {"w": torch.randn(3, 5, generator=g).bfloat16()}
    state = opt.OptState(4, {"w": torch.randn(3, 5, generator=g)},
                         {"w": torch.rand(3, 5, generator=g)})
    tree = {"params": params, "opt": state}
    path = ckpt.save(str(tmp_path), 4, tree)
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["leaves"]["params/w"]["dtype"] == "bfloat16"
    assert set(manifest["leaves"]) == {"params/w", "opt/step", "opt/m/w",
                                       "opt/v/w"}
    like = {"params": {"w": torch.zeros(3, 5, dtype=torch.bfloat16)},
            "opt": opt.init_opt_state({"w": torch.zeros(3, 5)})}
    restored, _ = ckpt.restore_latest(str(tmp_path), like)
    assert restored["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(restored["params"]["w"], params["w"])
    assert isinstance(restored["opt"], opt.OptState)
    assert restored["opt"].step == 4
    assert torch.equal(restored["opt"].m["w"], state.m["w"])
    assert torch.equal(restored["opt"].v["w"], state.v["w"])


# -- data pipeline and elastic policy -------------------------------------------

def test_pipeline_batches_equal_the_jax_package():
    cfg = dict(vocab_size=512, batch=3, seq_len=20, seed=5)
    mine = data_mod.TokenPipeline(data_mod.DataConfig(**cfg))
    theirs = jdata.TokenPipeline(jdata.DataConfig(**cfg))
    for step in (0, 1, 17):
        a, b = mine.batch_at(step), theirs.batch_at(step)
        assert set(a) == set(b) == {"tokens", "labels"}
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("n", [16, 17, 64, 100, 255, 256, 512, 1000])
def test_elastic_plans_equal_the_jax_package(n):
    assert elastic.plan_remesh(n) == jelastic.plan_remesh(n) or \
        (elastic.plan_remesh(n).__dict__ ==
         jelastic.plan_remesh(n).__dict__)
    mine, theirs = elastic.StragglerMonitor(), jelastic.StragglerMonitor()
    for i in range(40):
        for h in ("a", "b", "c"):
            t = 1.0 + (5.0 if h == "c" and i % 7 > 4 else 0.0)
            mine.record(h, t)
            theirs.record(h, t)
        assert mine.check() == theirs.check()


# -- launch.train: SIGTERM, resume, bits -----------------------------------------

ARGS = ["--arch", "xlstm-125m", "--smoke", "--batch", "2", "--seq", "16",
        "--steps", "6", "--ckpt-every", "100", "--log-every", "100",
        "--device", "cpu"]


def _final_params(path):
    root = path / (path / "LATEST").read_text()
    manifest = json.loads((root / "manifest.json").read_text())
    return manifest, {k: np.load(root / v["file"])
                      for k, v in manifest["leaves"].items()}


def test_resumed_run_is_bit_identical(tmp_path):
    torch.set_num_threads(1)
    straight = launch_train.run(ARGS + ["--ckpt", str(tmp_path / "a")])
    assert straight["steps"] == 6 and not straight["stopped"]

    @contextlib.contextmanager
    def preempt(step):
        yield
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    first = launch_train.run(ARGS + ["--ckpt", str(tmp_path / "b")],
                             wrap_step=preempt)
    assert first["stopped"] and first["steps"] == 3
    manifest, _ = _final_params(tmp_path / "b")
    assert manifest["step"] == 3 and manifest["extra"]["next_step"] == 3
    second = launch_train.run(ARGS + ["--ckpt", str(tmp_path / "b"),
                                      "--resume", "auto"])
    assert second["start_step"] == 3 and second["steps"] == 3
    assert first["losses"] + second["losses"] == straight["losses"]
    ma, a = _final_params(tmp_path / "a")
    mb, b = _final_params(tmp_path / "b")
    assert ma["step"] == mb["step"] == 6 and set(a) == set(b)
    assert a["opt/step"] == b["opt/step"] == 6
    for k in a:
        assert np.array_equal(a[k], b[k]), k
    assert straight["losses"][-1] < straight["losses"][0]
