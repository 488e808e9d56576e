"""The port's stacked superbatch and trace accounting against the JAX
package's.

The superbatch is the JAX package's ``jax.vmap`` of the scorer body over
a leading member axis; in the port each layer is one grouped launch of
the conv and scorer-head kernels, whose plain versions (the CPU path
here) loop over the members. Inputs are made with numpy from a seed;
operator weights are the JAX package's init, carried across with
``params_from_jax``.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.core import operators as jops  # noqa: E402
from repro.core import runtime as jrt  # noqa: E402
from repro.kernels import conv_scorer as jconv  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core import runtime as trt  # noqa: E402
from repro_torch.kernels import conv_scorer as cs  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import scorer_head as sh  # noqa: E402

# (H, Cin, Cout) of three family layers: op_L2c8s25's first, op_L3c16s50's
# second and op_L5c32s100's last
CONV_SHAPES = [(25, 3, 8), (25, 16, 16), (7, 32, 32)]
SIGS = [(2, 8, 16, 25), (3, 16, 32, 50)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """One torch thread: the suite runs test files in parallel workers
    beside JAX's own threads."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _conv_inputs(q, n, h, cin, cout, seed):
    rng = np.random.default_rng(seed)
    return (rng.uniform(size=(q, n, h, h, cin)).astype(np.float32),
            (rng.standard_normal((q, 3, 3, cin, cout)) /
             np.sqrt(9 * cin)).astype(np.float32),
            rng.standard_normal((q, cout)).astype(np.float32))


@pytest.mark.parametrize("q", [2, 3])
@pytest.mark.parametrize("h,cin,cout", CONV_SHAPES)
def test_grouped_conv_matches_vmapped_pallas_kernel(h, cin, cout, q):
    """The grouped conv's plain version against ``jax.vmap`` of the
    Pallas kernel (interpret mode) over the member axis, within 1e-4
    (``tests/test_kernels.py``'s conv tolerance); each member equals the
    ungrouped plain conv on its own inputs bit for bit."""
    x, w, b = _conv_inputs(q, 3, h, cin, cout, seed=h + cin + q)
    pallas = jax.vmap(functools.partial(jconv.conv_scorer, interpret=True))
    want = np.asarray(pallas(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    xt, wt, bt = map(torch.from_numpy, (x, w, b))
    got = cs.conv_scorer(xt, wt, bt)
    assert got.shape == want.shape == (q, 3, -(-h // 2), -(-h // 2), cout)
    assert_allclose(got.numpy(), want, rtol=0, atol=1e-4)
    for m in range(q):
        assert torch.equal(got[m], cs.conv_scorer(xt[m], wt[m], bt[m]))


def test_grouped_conv_rejects_mismatched_members():
    x, w, b = map(torch.from_numpy, _conv_inputs(2, 2, 13, 8, 8, seed=0))
    with pytest.raises(ValueError, match="member counts"):
        cs.conv_scorer(x, w[:1].contiguous(), b)
    with pytest.raises(ValueError, match="leading member axis"):
        cs.conv_scorer(x, w[0], b)


@pytest.mark.parametrize("q,m,feat,dense", [(2, 20, 392, 16),
                                            (3, 64, 512, 64),
                                            (8, 5, 784, 32)])
def test_grouped_scorer_head_equals_each_member(q, m, feat, dense):
    """The grouped dense-and-head layers: each member exactly the
    ungrouped plain version on its own rows and weights."""
    rng = np.random.default_rng(q * m)
    args = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.uniform(size=(q, m, feat)),
        rng.standard_normal((q, feat, dense)) * np.sqrt(2 / feat),
        0.1 * rng.standard_normal((q, dense)),
        rng.standard_normal((q, dense, 2)) / np.sqrt(dense),
        0.1 * rng.standard_normal((q, 2)))]
    got = sh.scorer_head(*args)
    assert got.shape == (q, m, 2)
    for g in range(q):
        assert torch.equal(got[g], ref.scorer_head(*(a[g] for a in args)))
    with pytest.raises(ValueError, match="leading member axis"):
        sh.scorer_head(args[0], args[1][0], *args[2:])


def _members(sig, q, seed):
    """q members of one signature: the JAX package's params and the
    port's copies of them."""
    jarch = jops.OperatorArch(f"sb{sig}", *sig)
    jps = [jops.init_operator(jarch, jax.random.PRNGKey(seed + g))
           for g in range(q)]
    tps = [tops.params_from_jax(jax.tree_util.tree_map(np.asarray, p),
                                "cpu") for p in jps]
    return jps, tps


@pytest.mark.parametrize("style", ["vmap", "unroll"])
@pytest.mark.parametrize("sig", SIGS, ids=jrt.sig_str)
def test_superbatch_matches_jax_super_fn(sig, style):
    """The port's superbatch layer against the JAX runtime's ``_super_fn``
    (``backend="jnp"``) on the JAX package's own params, within 1e-4 (no
    bit equality across the packages: their CPU convolutions sum in other
    orders, F1)."""
    q, bucket = 3, 64
    jps, tps = _members(sig, q, seed=10)
    x = np.random.default_rng(sig[3]).uniform(
        size=(q, bucket, sig[3], sig[3], 3)).astype(np.float32)
    jr = jrt.OperatorRuntime(backend="jnp", superbatch=style)
    stacked = jax.tree_util.tree_map(lambda *a: jnp.stack(a), *jps)
    wp, wc = jr._super_fn(sig)(stacked, jnp.asarray(x))
    tr = trt.OperatorRuntime(device="cpu")
    gp, gc = tr._dispatch(sig, trt.stack_params(tps), x, kind="super")
    assert gp.shape == gc.shape == (q, bucket)
    assert_allclose(gp.numpy(), np.asarray(wp), rtol=0, atol=1e-4)
    assert_allclose(gc.numpy(), np.asarray(wc), rtol=0, atol=1e-4)


@pytest.mark.parametrize("sig", SIGS, ids=jrt.sig_str)
def test_superbatch_equals_bucketed_layer_bitwise(sig):
    """Each member of the port's superbatch equals the bucketed layer on
    that member's chunk and params alone, bit for bit, and the scorer
    body calls the conv once per layer for the whole group."""
    q, bucket = 3, 64
    _, tps = _members(sig, q, seed=20)
    x = np.random.default_rng(sig[0]).uniform(
        size=(q, bucket, sig[3], sig[3], 3)).astype(np.float32)
    rt = trt.OperatorRuntime(device="cpu")
    calls = []
    conv = rt.conv

    def counted(xx, w, b):
        calls.append(tuple(xx.shape[:2]))
        return conv(xx, w, b)

    rt.conv = counted
    gp, gc = rt._dispatch(sig, trt.stack_params(tps), x, kind="super")
    assert calls == [(q, bucket)] * sig[0]
    for g in range(q):
        p, c = rt._dispatch(sig, tps[g], x[g], kind="bucketed")
        assert torch.equal(gp[g], p) and torch.equal(gc[g], c)
    assert rt.dispatch_stats()["super_calls"] == 1


def test_trace_guard_raises_on_retrace():
    """TraceGuard surfaces a retrace as RetraceError with the offending
    signature and shape in the message (``tests/test_fleet.py``'s case
    on the port's runtime)."""
    rt = trt.OperatorRuntime(device="cpu")
    sig = (2, 8, 16, 25)
    with pytest.raises(trt.RetraceError, match="L2c8d16s25"):
        with trt.TraceGuard(rt):
            rt._record_trace(sig, (64, 25, 25, 3))
            rt._record_trace(sig, (64, 25, 25, 3))
    with trt.TraceGuard(rt):
        rt._record_trace(sig, (128, 25, 25, 3))
        rt._record_trace(sig, (256, 25, 25, 3))


class _Trained:
    def __init__(self, arch, params):
        self.arch, self.params = arch, params


class _Bank:
    def __init__(self, n, seed):
        self._crops = {s: np.random.default_rng((seed, s)).uniform(
            size=(n, s, s, 3)).astype(np.float32) for s in (25, 50)}

    def crops(self, idxs, region, size):
        return self._crops[size][np.asarray(idxs, np.int64)]


def test_trace_accounting_matches_jax_runtime():
    """The same mix of small, bucketed and fused dispatches, twice: the
    port's first dispatches per (layer, signature, shape) are the JAX
    runtime's traces, key for key, the same ``n_compiled`` and grouped
    traces, and the repeat round adds none (TraceGuard holds)."""
    bank = _Bank(300, seed=5)
    pairs = []
    for i, sig in enumerate(SIGS):
        (jp,), (tp,) = _members(sig, 1, seed=30 + i)
        pairs.append((_Trained(jops.OperatorArch(f"ta{i}", *sig), jp),
                      _Trained(tops.OperatorArch(f"ta{i}", *sig), tp)))
    kw = dict(chunk=128, small_flops=2e8)
    jr = jrt.OperatorRuntime(backend="jnp", **kw)
    tr = trt.OperatorRuntime(device="cpu", **kw)

    def workload(rt, side):
        a, b = (p[side] for p in pairs)
        for t in (a, b):
            rt.score_crops(t.params, t.arch,
                           bank.crops(np.arange(40), None, t.arch.input_size))
        rt.score_demands([(a, bank, np.arange(90)),
                          (a, bank, np.arange(100, 190)),
                          (a, bank, np.arange(50)),
                          (b, bank, np.arange(70)),
                          (b, bank, np.arange(200, 50, -1))], group_max=3)

    for rt, side in ((jr, 0), (tr, 1)):
        workload(rt, side)
        with jrt.TraceGuard(rt) if side == 0 else trt.TraceGuard(rt) as g:
            workload(rt, side)
        assert g.new_traces == {}
    assert tr._shape_traces == jr._shape_traces
    assert tr._traces == jr._traces and tr.trace_count() == jr.trace_count()
    assert tr._group_traces == jr._group_traces and tr._group_traces
    assert tr.n_compiled == jr.n_compiled
    assert tr.dispatch_stats() == jr.dispatch_stats()
    assert tr.mesh_info() == {"device_count": 1, "mesh_shape": None,
                              "sharded": False}
