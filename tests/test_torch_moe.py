"""The port's MoE path against the JAX package's.

On the CPU the port's ``ops.moe_gmm`` takes its plain version; it is
held against the JAX package's reference and against the Pallas kernel
in interpret mode, at ``tests/test_kernels.py``'s shapes and tolerances
(1e-4 in float32, 5e-2 in bfloat16). ``moe_forward`` is held against
``repro.models.moe.moe_forward`` (float32, 1e-4, identical top-k
experts), and granite-moe-3b-a800m's smoke config (2 layers, d = 64,
8 experts padded to 16, top-2) against ``repro.models.transformer`` and
the JAX serving engine, with the JAX package's weights carried across by
``params_from_jax``. Inputs come from NumPy with a seed. The CUDA kernel
runs only on the card: ``tests/test_torch_cuda.py`` holds it against the
plain version there.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro.configs.base import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.moe_gmm import moe_gmm as pallas_gmm  # noqa: E402
from repro.models import layers as jlayers, moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.serving.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import moe, transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

ARCH = "granite-moe-3b-a800m"
TOL = dict(rtol=1e-4, atol=1e-4)
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    torch.set_num_threads(1)


# -- the grouped matmul -------------------------------------------------------

@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("E,C,d,f", [(4, 128, 256, 128), (2, 256, 128, 256),
                                     (3, 40, 64, 32)])
def test_moe_gmm_matches_pallas_and_reference(name, E, C, d, f):
    """(3, 40, 64, 32): a capacity that is no multiple of a tile."""
    jdt, tdt, tol = DTYPES[name]
    rng = np.random.default_rng(E * 1000 + C)
    x = rng.standard_normal((E, C, d)).astype(np.float32)
    w = rng.standard_normal((E, d, f)).astype(np.float32)
    jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    got = ops.moe_gmm(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt))
    assert got.dtype == tdt and got.shape == (E, C, f)
    got = got.float().numpy()
    want_ref = np.asarray(jref.moe_gmm(jx, jw).astype(jnp.float32))
    want_kernel = np.asarray(pallas_gmm(
        jx, jw, block_c=min(128, C), block_k=min(128, d),
        block_f=min(128, f), interpret=True).astype(jnp.float32))
    assert_allclose(got, want_ref, rtol=tol, atol=tol)
    assert_allclose(got, want_kernel, rtol=tol, atol=tol)


def test_moe_gmm_rejects_what_it_does_not_take():
    x, w = torch.zeros(2, 3, 8), torch.zeros(2, 8, 16)
    with pytest.raises(TypeError):
        ops.moe_gmm(x.half(), w.half())
    with pytest.raises(TypeError):
        ops.moe_gmm(x, w.bfloat16())
    with pytest.raises(ValueError):
        ops.moe_gmm(x, torch.zeros(3, 8, 16))        # expert counts differ
    with pytest.raises(ValueError):
        ops.moe_gmm(x, torch.zeros(2, 4, 16))        # inner dims differ


# -- moe_forward --------------------------------------------------------------

# (d, ff, E, top_k, capacity_factor, shared, x shape): the first is the
# smoke width; the drops case is tests/test_models.py::
# test_moe_capacity_drops_bounded's set-up, the dead-experts case its
# test_moe_padded_experts_never_routed's (5 experts padded to 16)
MOE_CASES = {
    "top2": (64, 32, 8, 2, 1.25, 0, (2, 8, 64)),
    "capacity_drops": (8, 16, 2, 1, 0.25, 0, (1, 64, 8)),
    "dead_padded_experts": (16, 32, 5, 2, 4.0, 0, (4, 16, 16)),
    "shared_expert": (64, 32, 8, 2, 1.25, 1, (2, 8, 64)),
}


def _jax_top_k(x, params, E, top_k):
    """The JAX package's routing, step for step (``moe.py:60-67``)."""
    logits = (x @ params["router"]).astype(jnp.float32)
    ep = params["router"].shape[-1]
    logits = jnp.where((jnp.arange(ep) >= E)[None], -1e30, logits)
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                                    top_k)[1])


@pytest.mark.parametrize("case", MOE_CASES)
def test_moe_forward_matches_jax(case):
    d, ff, E, k, cf, shared, shape = MOE_CASES[case]
    p = jmoe.init_moe(jax.random.PRNGKey(len(case)), d, ff, E, shared, (),
                      jnp.float32)
    params = jlayers.split_annotated(p)[0]
    assert params["router"].shape[-1] == moe.padded_experts(E) == 16
    x = np.random.default_rng(d + E).standard_normal(shape).astype(np.float32)
    want, (jlb, jz) = jax.jit(functools.partial(
        jmoe.moe_forward, n_experts=E, top_k=k, capacity_factor=cf,
        compute_dtype=jnp.float32))(jnp.asarray(x), params)
    tree = {n: torch.from_numpy(np.array(v)) for n, v in params.items()
            if n != "shared"}
    if shared:
        tree["shared"] = {n: torch.from_numpy(np.array(v))
                          for n, v in params["shared"].items()}
    tp = moe.real_experts(tree, E)
    assert tp["wg"].shape == (E, d, ff) and tp["router"].shape == (d, E)
    got, (lb, z) = moe.moe_forward(torch.from_numpy(x), tp, n_experts=E,
                                   top_k=k, capacity_factor=cf)
    xf = x.reshape(-1, d)
    got_i = moe.route(torch.from_numpy(xf), tp["router"], k)[3].numpy()
    np.testing.assert_array_equal(got_i, _jax_top_k(jnp.asarray(xf), params,
                                                    E, k))
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert_allclose([float(lb), float(z)], [float(jlb), float(jz)],
                    rtol=1e-5, atol=1e-6)
    dropped = np.all(np.asarray(want) == 0, axis=-1)
    assert dropped.any() == (case == "capacity_drops")
    np.testing.assert_array_equal(np.all(got.numpy() == 0, axis=-1), dropped)


def test_real_experts_needs_the_padded_count():
    p = {"router": torch.zeros(4, 16), "wg": torch.zeros(16, 4, 2),
         "wu": torch.zeros(16, 4, 2), "wo": torch.zeros(16, 2, 4)}
    assert moe.real_experts(p, 5)["wo"].shape == (5, 2, 4)
    with pytest.raises(ValueError, match="pads"):
        moe.real_experts({**p, "router": torch.zeros(4, 8)}, 5)
    with pytest.raises(ValueError, match="real experts"):
        moe.moe_forward(torch.zeros(1, 2, 4), p, n_experts=5, top_k=2,
                        capacity_factor=1.0)


# -- granite-moe-3b-a800m's smoke config --------------------------------------

@pytest.fixture(scope="module")
def granite():
    jcfg = jax_smoke_config(ARCH).scaled(remat=False)
    params = jlayers.split_annotated(
        jtf.init_model(jcfg, jax.random.PRNGKey(0)))[0]
    cfg = get_smoke_config(ARCH).scaled(remat=False)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, params, cfg, tree, params_from_jax(cfg, tree, device="cpu")


def test_params_from_jax_keeps_the_real_experts(granite):
    jcfg, params, cfg, tree, model = granite
    ffn = model.blocks[1].ffn
    assert isinstance(ffn, moe.MoE)
    assert ffn.wg.shape == (8, 64, 32) and ffn.router.shape == (64, 8)
    assert_allclose(ffn.wo.numpy(), tree["blocks"][0]["ffn"]["wo"][1][:8])
    bad = jax.tree_util.tree_map(lambda a: a, tree)
    bad["blocks"][0]["ffn"]["router"] = bad["blocks"][0]["ffn"]["router"][..., :8]
    with pytest.raises(ValueError, match="pads"):
        params_from_jax(cfg, bad, device="cpu")


def test_prefill_and_decode_logits_match_jax(granite):
    """Prefill of two 13-token prompts (the 26 tokens of the forward
    share 9 capacity rows per expert), then 6 decode steps of the two
    rows at different depths."""
    jcfg, params, cfg, tree, model = granite
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 256, size=(2, 13))
    jlogits, jcaches = jax.jit(functools.partial(jtf.prefill, jcfg))(
        params, jnp.asarray(tokens))
    logits, caches = tf.prefill(model, torch.from_numpy(tokens).long())
    assert logits.shape == (2, 1, 256)
    assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for i, c in enumerate(caches):
        assert_allclose(c["k"].numpy(), np.asarray(jcaches[0]["k"][i]), **TOL)
    pad = [(0, 0), (0, 0), (0, 19), (0, 0), (0, 0)]
    jcaches = jax.tree_util.tree_map(lambda a: jnp.pad(a, pad), jcaches)
    ring = tf.init_caches(cfg, 2, 32, device="cpu")
    for c, new in zip(ring, caches):
        for name in ("k", "v"):
            c[name][:, :13] = new[name]
    step = jax.jit(lambda p, c, t, q: jtf.decode_step(jcfg, p, c, t, q))
    pos = np.array([13, 9])
    for _ in range(6):
        nxt = rng.integers(0, 256, size=(2, 1))
        jlogits, jcaches = step(params, jcaches, jnp.asarray(nxt),
                                jnp.asarray(pos, jnp.int32))
        logits, ring = tf.decode_step(model, ring, torch.from_numpy(nxt),
                                      torch.from_numpy(pos))
        assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        pos = pos + 1


def test_init_model_draws_the_jax_scales():
    cfg = get_smoke_config(ARCH)
    model = tf.init_model(cfg, torch.Generator().manual_seed(3), device="cpu")
    ffn = model.blocks[0].ffn
    assert ffn.wg.shape == (8, 64, 32) and ffn.wo.shape == (8, 32, 64)
    # repro/models/layers.py::param: fan-in shape[-2], here the true one
    assert abs(float(ffn.router.std()) - 64 ** -0.5) < 0.02
    assert abs(float(ffn.wg.std()) - 64 ** -0.5) < 0.02
    assert abs(float(ffn.wo.std()) - 32 ** -0.5) < 0.02
    logits, _ = tf.prefill(model, torch.zeros(1, 5, dtype=torch.long))
    assert torch.isfinite(logits).all()


# the workloads of tests/test_serving.py: (slots, [(prompt, max_new)])
WORKLOADS = {
    "completion": (2, [(np.arange(3 + i) % 256, 5) for i in range(5)]),
    "isolation": (2, [(np.array([5, 9, 2, 7, 1]), 4),
                      (np.array([3, 3, 8]), 4)]),
    "slot_reuse": (1, [(np.array([1, 2, 3]), 3)] * 3),
    "ring_end": (2, [(np.arange(60) % 256, 16), (np.array([1, 2, 3]), 2)]),
}


@pytest.mark.parametrize("workload", WORKLOADS)
def test_greedy_tokens_match_the_jax_engine(granite, workload):
    jcfg, params, cfg, tree, model = granite
    slots, reqs = WORKLOADS[workload]
    jeng = JaxEngine(jcfg, params, slots=slots, cache_len=64)
    eng = ServeEngine(model, slots=slots, cache_len=64, device="cpu")
    for prompt, max_new in reqs:
        assert jeng.submit(prompt, max_new) == eng.submit(prompt, max_new)
    want, got = jeng.run(), eng.run()
    assert got == want
    assert {r: q.truncated for r, q in eng.requests.items()} == \
        {r: q.truncated for r, q in jeng.requests.items()}
