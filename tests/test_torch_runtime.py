"""The port's OperatorRuntime against the JAX package's.

Both runtimes get the same weights (the JAX package's init, carried
across) and the same numpy crops; the port runs with ``device="cpu"``,
the JAX package with ``backend="jnp"``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.core import operators as jops  # noqa: E402
from repro.core import runtime as jrt  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core import runtime as trt  # noqa: E402
from repro_torch.kernels import conv_scorer as cs  # noqa: E402

SIGS = [(2, 8, 16, 25), (3, 16, 32, 50)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """PyTorch's CPU kernels take one thread per core by default; the
    suite runs test files in parallel workers beside JAX's own threads,
    so one thread each keeps the host from being oversubscribed."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


class _Trained:
    def __init__(self, arch, params):
        self.arch, self.params = arch, params


class _Bank:
    """FrameBank stand-in: fixed numpy crops per input size."""

    def __init__(self, n, seed):
        self._crops = {s: np.random.default_rng((seed, s)).uniform(
            size=(n, s, s, 3)).astype(np.float32) for s in (25, 50)}

    def crops(self, idxs, region, size):
        return self._crops[size][np.asarray(idxs, np.int64)]


def _pair(sig, seed):
    jarch = jops.OperatorArch(f"rt{sig}", *sig)
    jp = jops.init_operator(jarch, jax.random.PRNGKey(seed))
    tp = tops.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return (_Trained(jarch, jp),
            _Trained(tops.OperatorArch(f"rt{sig}", *sig), tp))


def _workload(rt_score_crops, rt_score_demands, pairs, bank, side):
    """One fixed mix of score_crops and score_demands calls; ``side``
    picks the JAX (0) or the port's (1) half of each pair."""
    out = []
    for i, pair in enumerate(pairs):
        t = pair[side]
        for n in (1, 40, 100, 300):       # small, boundary and chunked
            out.append(rt_score_crops(t.params, t.arch,
                                      bank.crops(np.arange(n), None,
                                                 t.arch.input_size)))
    demands = [(pairs[0][side], bank, np.arange(90)),
               (pairs[0][side], bank, np.arange(100, 190)),
               (pairs[1][side], bank, np.arange(70)),
               (pairs[0][side], bank, np.arange(0)),
               (pairs[1][side], bank, np.arange(200, 50, -1))]
    out += rt_score_demands(demands, group_max=2)
    return out


def test_runtime_matches_jax_runtime_scores_and_counters():
    """Scores within 1e-5 of the JAX runtime's, and the same dispatch
    counters and shape vocabulary: both runtimes take the same layer and
    the same padded shape for every batch."""
    pairs = [_pair(s, seed=i) for i, s in enumerate(SIGS)]
    bank = _Bank(300, seed=3)
    # small_flops between the two archs' per-batch costs, chunk 128, so
    # every layer is taken: small, bucketed, chunked and superbatch
    kw = dict(chunk=128, small_flops=2e8)
    jr = jrt.OperatorRuntime(backend="jnp", **kw)
    tr = trt.OperatorRuntime(device="cpu", **kw)
    want = _workload(jr.score_crops, jr.score_demands, pairs, bank, 0)
    got = _workload(tr.score_crops, tr.score_demands, pairs, bank, 1)
    for (gp, gc), (wp, wc) in zip(got, want):
        assert gp.dtype == np.float64 and gp.shape == wp.shape
        assert_allclose(gp, wp, rtol=1e-5, atol=1e-5)
        assert_allclose(gc, wc, rtol=1e-5, atol=1e-5)
    assert tr.dispatch_stats() == jr.dispatch_stats()
    assert tr.shape_vocab() == jr.shape_vocab()
    stats = tr.dispatch_stats()
    assert min(stats["small_calls"], stats["bucketed_calls"],
               stats["super_calls"]) > 0


def test_dispatch_layers_agree():
    """Small, bucketed and superbatch dispatch of the same frames agree.
    On the CPU, PyTorch's convolution and matmul may block a 32-row and a
    64-row batch differently, so bit equality is not asserted here; the
    tolerance, 1e-6 absolute on probabilities and counts of order 1, is
    a few float32 ulps. (On the card the convolution is bitwise
    independent of the batch by construction; chip_smoke.py prints the
    largest difference of the whole scorer.)"""
    _, t = _pair((3, 16, 32, 50), seed=7)
    bank = _Bank(300, seed=1)
    idxs = np.arange(20)
    small = trt.OperatorRuntime(device="cpu", small_flops=1e12)
    bucketed = trt.OperatorRuntime(device="cpu", small_flops=0)
    p_s, c_s = small.score(t, bank, idxs)
    p_b, c_b = bucketed.score(t, bank, idxs)
    (p_g, c_g), _ = bucketed.score_demands(
        [(t, bank, idxs), (t, bank, np.arange(20, 40))], group_max=2)
    assert small.small_calls == 1 and bucketed.bucketed_calls == 1
    assert bucketed.super_calls == 1
    assert small.shape_vocab() == {"L3c16d32s50": [(32, 50, 50, 3)]}
    for p, c in ((p_b, c_b), (p_g, c_g)):
        assert_allclose(p, p_s, rtol=0, atol=1e-6)
        assert_allclose(c, c_s, rtol=0, atol=1e-6)
    ep, ec = tops.score_frames(t.params, bank.crops(idxs, None, 50))
    assert_allclose(p_s, ep, rtol=0, atol=1e-6)
    assert_allclose(c_s, ec, rtol=0, atol=1e-6)


def test_results_stay_on_device_until_consumed():
    _, t = _pair((2, 8, 16, 25), seed=2)
    bank = _Bank(300, seed=2)
    rt = trt.OperatorRuntime(device="cpu", small_flops=0)
    batcher = trt.ScoreBatcher(rt, group_max=2)
    h1 = batcher.submit(t, bank, np.arange(100))
    assert not h1.dispatched and batcher.pending() == 1
    with pytest.raises(RuntimeError, match="flush"):
        h1.result()
    h2 = batcher.submit(t, bank, np.arange(100, 200))
    assert h1.dispatched and batcher.in_flight == 1
    assert batcher.watermark_fires["group_max"] == 1
    p1, _ = h1.result()
    assert batcher.in_flight == 0 and p1.shape == (100,)
    h3 = batcher.submit(t, bank, np.arange(10))
    batcher.fire_complete({(9, 9, 9, 9)})
    assert batcher.watermark_fires["bucket_complete"] == 1
    assert h2.result()[0].shape == (100,) and h3.result()[0].shape == (10,)
    empty = trt.OperatorRuntime(device="cpu").score_crops(
        t.params, t.arch, np.empty((0, 25, 25, 3), np.float32))
    assert empty[0].shape == (0,)


def test_runtime_device_rule(monkeypatch):
    """No device means the card: the runtime raises without one, and
    with one it holds the CUDA kernel's wrapper, never the plain
    version."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        trt.OperatorRuntime()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    rt = trt.OperatorRuntime()
    assert rt.device == torch.device("cuda")
    assert rt.conv.func is cs.conv_scorer
    cpu = trt.OperatorRuntime(device="cpu")
    assert cpu.device == torch.device("cpu")
    prev = trt.set_runtime(cpu)
    try:
        assert trt.get_runtime() is cpu
    finally:
        trt.set_runtime(prev)
