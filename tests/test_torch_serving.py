"""The port's serving engine against the JAX package's, and the seven
invariants of ``tests/test_serving.py`` on the port alone.

h2o-danube-1.8b's smoke config with the JAX package's weights carried
across by ``params_from_jax``; the port serves on the CPU
(``device="cpu"``), through the kernels' plain versions. Greedy tokens
must be identical to the JAX engine's. Sampled tokens come from the
port's own per-(seed, rid, step) generators, so they are held to the
invariant (independent of co-batching), not to JAX's draws.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.base import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import layers as jlayers, transformer as jtf  # noqa: E402
from repro.serving.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

ARCH = "h2o-danube-1.8b"
P1 = np.array([5, 9, 2, 7, 1], np.int32)
P2 = np.array([3, 3, 8], np.int32)


@pytest.fixture(scope="module")
def small_lm():
    torch.set_num_threads(1)
    jcfg = jax_smoke_config(ARCH).scaled(remat=False)
    params = jlayers.split_annotated(
        jtf.init_model(jcfg, jax.random.PRNGKey(0)))[0]
    cfg = get_smoke_config(ARCH).scaled(remat=False)
    model = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, params),
                            device="cpu")
    return jcfg, params, model


def _engine(model, **kw):
    return ServeEngine(model, device="cpu", **kw)


# the workloads of tests/test_serving.py: (slots, [(prompt, max_new)])
WORKLOADS = {
    "completion": (2, [(np.arange(3 + i) % 256, 5) for i in range(5)]),
    "isolation": (2, [(P1, 4), (P2, 4)]),
    "slot_reuse": (1, [(np.array([1, 2, 3]), 3)] * 3),
    "ring_end": (2, [(np.arange(60) % 256, 16), (np.array([1, 2, 3]), 2)]),
}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_greedy_tokens_match_the_jax_engine(small_lm, workload):
    jcfg, params, model = small_lm
    slots, reqs = WORKLOADS[workload]
    jeng = JaxEngine(jcfg, params, slots=slots, cache_len=64)
    eng = _engine(model, slots=slots, cache_len=64)
    for prompt, max_new in reqs:
        assert jeng.submit(prompt, max_new) == eng.submit(prompt, max_new)
    want, got = jeng.run(), eng.run()
    assert got == want
    assert {r: q.truncated for r, q in eng.requests.items()} == \
        {r: q.truncated for r, q in jeng.requests.items()}


def test_engine_completes_requests(small_lm):
    model = small_lm[2]
    eng = _engine(model, slots=2, cache_len=64)
    rids = [eng.submit(np.arange(3 + i) % 256, max_new=5) for i in range(5)]
    results = eng.run()
    assert set(results) == set(rids)
    assert all(len(v) == 5 for v in results.values())
    assert all(0 <= t < 256 for v in results.values() for t in v)


def test_engine_greedy_matches_full_reforward(small_lm):
    """Engine output (temperature 0) == argmax of a full re-forward at
    every step: the in-place cache write and the ring are exact."""
    model = small_lm[2]
    eng = _engine(model, slots=2, cache_len=64)
    rid = eng.submit(P1, max_new=6)
    got = eng.run()[rid]
    seq, want = list(P1), []
    for _ in range(6):
        logits, _ = tf.prefill(model, torch.tensor([seq]))
        want.append(int(logits[0, -1].argmax()))
        seq.append(want[-1])
    assert got == want


def test_engine_batching_is_isolation_safe(small_lm):
    model = small_lm[2]
    solo = _engine(model, slots=2, cache_len=64)
    r = solo.submit(P1, max_new=4)
    want = solo.run()[r]
    multi = _engine(model, slots=2, cache_len=64)
    ra = multi.submit(P1, max_new=4)
    multi.submit(P2, max_new=4)
    assert multi.run()[ra] == want


def test_engine_slot_reuse(small_lm):
    model = small_lm[2]
    eng = _engine(model, slots=1, cache_len=64)
    rids = [eng.submit(np.array([1, 2, 3]), max_new=3) for _ in range(3)]
    results = eng.run()
    assert len(results) == 3
    assert len({tuple(results[r]) for r in rids}) == 1


def test_engine_rids_unique_across_runs(small_lm):
    model = small_lm[2]
    eng = _engine(model, slots=2, cache_len=64)
    first = eng.submit(np.array([5, 9, 2]), max_new=2)
    res1 = eng.run()
    second = eng.submit(np.array([3, 3, 8]), max_new=2)
    res2 = eng.run()
    assert first != second
    assert first in res1 and second in res2 and second not in res1
    assert eng.submit(np.array([1]), max_new=1, rid=7) == 7
    with pytest.raises(ValueError, match="duplicate rid"):
        eng.submit(np.array([1]), max_new=1, rid=first)


def test_engine_length_edges(small_lm):
    model = small_lm[2]
    eng = _engine(model, slots=2, cache_len=64)
    with pytest.raises(ValueError, match="max_new"):
        eng.submit(np.array([1, 2, 3]), max_new=0)
    with pytest.raises(ValueError, match="KV-ring"):
        eng.submit(np.arange(64) % 256, max_new=2)
    with pytest.raises(ValueError, match="non-empty"):
        eng.submit(np.array([], np.int32), max_new=2)
    rid = eng.submit(np.arange(60) % 256, max_new=16)
    out = eng.run()[rid]
    req = eng.requests[rid]
    assert req.done and req.truncated
    assert 0 < len(out) < 16
    rid2 = eng.submit(np.array([1, 2, 3]), max_new=2)
    assert len(eng.run()[rid2]) == 2
    assert not eng.requests[rid2].truncated


def test_engine_sampling_independent_of_cobatching(small_lm):
    """temperature > 0: a request's draws come from generators seeded by
    (seed, rid, step), so they are the same alone and co-batched."""
    model = small_lm[2]
    solo = _engine(model, slots=2, cache_len=64, temperature=0.8, seed=11)
    rs = solo.submit(P1, max_new=6, rid=42)
    want = solo.run()[rs]
    multi = _engine(model, slots=2, cache_len=64, temperature=0.8, seed=11)
    ra = multi.submit(P1, max_new=6, rid=42)
    multi.submit(P2, max_new=3)
    multi.submit(P2, max_new=5)
    assert multi.run()[ra] == want
    assert len(set(want)) > 1
    other = _engine(model, slots=2, cache_len=64, temperature=0.8, seed=12)
    other.submit(P1, max_new=6, rid=42)
    assert other.run()[42] != want


def test_engine_serves_on_the_card_by_default(small_lm, monkeypatch):
    """``device=None`` means the card: without one the engine raises and
    names ``device='cpu'``; a model elsewhere than the engine is refused."""
    model = small_lm[2]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="model is on cpu"):
        ServeEngine(model, device="cuda")
