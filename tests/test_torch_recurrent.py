"""The port's recurrent blocks (Mamba, mLSTM, sLSTM) against the JAX package's.

Module by module, the JAX package's init (float32) and the same NumPy
inputs go through ``repro/models/ssm.py`` / ``xlstm.py`` and the port's
``models/ssm.py`` / ``xlstm.py``, within 1e-4, across several chunks of
the scans, then decode steps from the prefill's cache; and both packages
refuse a prompt length the scans' chunks do not divide. The whole models
are in ``tests/test_torch_recurrent_serving.py``. The port runs on the
CPU, with one torch thread.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro.models import layers as jlayers, ssm as jssm  # noqa: E402
from repro.models import xlstm as jxlstm  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.models import ssm, transformer as tf, xlstm  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    torch.set_num_threads(1)


def _params(tree):
    """A JAX init's Annot tree -> (JAX arrays, the port's tensors)."""
    params = jlayers.split_annotated(tree)[0]
    return params, {n: torch.from_numpy(np.array(a))
                    for n, a in params.items()}


def _x(shape, seed, scale=0.5):
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def _close(got, want):
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        assert_allclose(g.numpy(), np.asarray(w), **TOL)


# -- Mamba --------------------------------------------------------------------

@pytest.mark.parametrize("L,chunk", [(64, 16), (5, 16), (2, 512)])
def test_mamba_forward_and_decode_match(L, chunk):
    """The chunked scan (4 chunks of 16 at L 64; one short chunk; a
    2-token prompt's conv tail of one row), then three decode steps from
    the prefill's cache."""
    d, N = 16, 8
    jp, p = _params(jssm.init_mamba(
        jax.random.PRNGKey(L), d, d_state=N, d_conv=4, expand=2, dt_rank=4,
        stack=(), dtype=jnp.float32))
    x = _x((2, L, d), L)
    want, jcache = jssm.mamba_forward(jnp.asarray(x), jp, d_state=N,
                                      chunk=chunk, compute_dtype=jnp.float32)
    got, cache = ssm.mamba_forward(torch.from_numpy(x), p, d_state=N,
                                   chunk=chunk)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the JAX package's tail xin[:, L-3:]: one row at L 1 and 2 (F6)
    assert cache["conv"].shape == (2, len(range(L)[L - 3:]), 2 * d)
    _close([cache["h"], cache["conv"]], [jcache["h"], jcache["conv"]])
    # a conv tail under 3 rows is padded at the end, as the JAX engine's
    # splice does (F6)
    pad = 3 - cache["conv"].shape[1]
    cache["conv"] = torch.nn.functional.pad(cache["conv"], (0, 0, 0, pad))
    jcache["conv"] = jnp.pad(jcache["conv"], ((0, 0), (0, pad), (0, 0)))
    for t in range(3):
        xt = _x((2, 1, d), 100 + t)
        want, jcache = jssm.mamba_decode(jnp.asarray(xt), jp, jcache,
                                         d_state=N, compute_dtype=jnp.float32)
        got, cache = ssm.mamba_decode(torch.from_numpy(xt), p, cache,
                                      d_state=N)
        assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _close([cache["h"], cache["conv"]], [jcache["h"], jcache["conv"]])


@pytest.mark.parametrize("L", [1, 7, 8, 33])
def test_linear_scan_is_the_recurrence(L):
    """The log-depth scan against the plain loop h_t = a_t h_{t-1} + b_t."""
    rng = np.random.default_rng(L)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, L, 3, 4)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, L, 3, 4)).astype(np.float32))
    cum, h = ssm.linear_scan_(a.clone(), b.clone())
    want_h, want_cum = torch.zeros(2, 3, 4), torch.ones(2, 3, 4)
    for t in range(L):
        want_h = a[:, t] * want_h + b[:, t]
        want_cum = want_cum * a[:, t]
        assert_allclose(h[:, t].numpy(), want_h.numpy(), rtol=1e-5, atol=1e-5)
        assert_allclose(cum[:, t].numpy(), want_cum.numpy(), rtol=1e-5,
                        atol=1e-6)


# -- mLSTM --------------------------------------------------------------------

def _mlstm_inputs(B, L, H, Dh, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, L, H, Dh)).astype(np.float32) * 0.5
               for _ in range(3))
    f_pre = rng.standard_normal((B, L, H)).astype(np.float32)
    log_f = -np.logaddexp(0, -f_pre).astype(np.float32)       # <= 0
    g = rng.standard_normal((B, L, H)).astype(np.float32)
    return q, k, v, log_f, g


@pytest.mark.parametrize("L,chunk", [(64, 16), (12, 256)])
def test_mlstm_chunked_and_step_match(L, chunk):
    """Four chunks of 16 (the carry across chunks), or one short chunk;
    then decode steps from the final state."""
    B, H, Dh = 2, 2, 16
    args = _mlstm_inputs(B, L, H, Dh, L)
    jst = jxlstm.init_mlstm_state(B, H, Dh)
    want, jst = jxlstm.mlstm_chunked(*map(jnp.asarray, args), jst,
                                     chunk=chunk)
    got, st = xlstm.mlstm_chunked(*map(torch.from_numpy, args),
                                  xlstm.init_mlstm_state(B, H, Dh, "cpu"),
                                  chunk=chunk)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _close(st, jst)
    for t in range(3):
        q, k, v, log_f, g = (a[:, 0] for a in _mlstm_inputs(B, 1, H, Dh, t))
        want, jst = jxlstm.mlstm_step(*map(jnp.asarray, (q, k, v, log_f, g)),
                                      jst)
        got, st = xlstm.mlstm_step(*map(torch.from_numpy, (q, k, v, log_f, g)),
                                   st)
        assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _close(st, jst)


@pytest.mark.parametrize("L", [40, 2])
def test_mlstm_block_forward_and_decode_match(L):
    d, H = 32, 2
    jp, p = _params(jxlstm.init_mlstm(jax.random.PRNGKey(3), d, H, expand=2,
                                      stack=(), dtype=jnp.float32))
    x = _x((2, L, d), L)
    want, jcache = jxlstm.mlstm_forward(jnp.asarray(x), jp, n_heads=H,
                                        compute_dtype=jnp.float32)
    got, cache = xlstm.mlstm_forward(torch.from_numpy(x), p, n_heads=H)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _close([cache["state"], cache["conv"]], [jcache["state"], jcache["conv"]])
    pad = 3 - cache["conv"].shape[1]
    cache["conv"] = torch.nn.functional.pad(cache["conv"], (0, 0, 0, pad))
    jcache["conv"] = jnp.pad(jcache["conv"], ((0, 0), (0, pad), (0, 0)))
    for t in range(3):
        xt = _x((2, 1, d), 50 + t)
        want, jcache = jxlstm.mlstm_decode(jnp.asarray(xt), jp, jcache,
                                           n_heads=H,
                                           compute_dtype=jnp.float32)
        got, cache = xlstm.mlstm_decode(torch.from_numpy(xt), p, cache,
                                        n_heads=H)
        assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _close([cache["state"], cache["conv"]],
               [jcache["state"], jcache["conv"]])


def test_head_rmsnorm_matches():
    h = _x((2, 5, 3, 16), 7, scale=3.0)
    scale = 1 + _x((48,), 8, scale=0.1)
    want = jxlstm._head_rmsnorm(jnp.asarray(h), jnp.asarray(scale))
    got = xlstm._head_rmsnorm(torch.from_numpy(h), torch.from_numpy(scale))
    assert_allclose(got.numpy(), np.asarray(want), **TOL)


# -- sLSTM --------------------------------------------------------------------

def test_slstm_scan_matches():
    B, L, H, dh = 2, 24, 2, 8
    pre = _x((B, L, H, 4 * dh), 9, scale=1.0)
    r = _x((H, dh, 4 * dh), 10, scale=dh ** -0.5)
    want, jst = jxlstm.slstm_scan(jnp.asarray(pre), jnp.asarray(r),
                                  jxlstm.init_slstm_state(B, H, dh))
    got, st = xlstm.slstm_scan(torch.from_numpy(pre), torch.from_numpy(r),
                               xlstm.init_slstm_state(B, H, dh, "cpu"))
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _close(st, jst)


def test_slstm_block_forward_and_decode_match():
    """The block with its folded tanh-GELU FFN; ffs = round(32*4/3/64)*64."""
    d, H, L = 32, 2, 10
    jp, p = _params(jxlstm.init_slstm(jax.random.PRNGKey(5), d, H,
                                      ff_expand=4.0 / 3.0, stack=(),
                                      dtype=jnp.float32))
    assert p["ff_down"].shape[0] == xlstm.ff_size(d, 4.0 / 3.0)
    x = _x((2, L, d), 11)
    want, jcache = jxlstm.slstm_forward(jnp.asarray(x), jp, n_heads=H,
                                        compute_dtype=jnp.float32)
    got, cache = xlstm.slstm_forward(torch.from_numpy(x), p, n_heads=H)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _close(cache["state"], jcache["state"])
    for t in range(3):
        xt = _x((2, 1, d), 60 + t)
        want, jcache = jxlstm.slstm_decode(jnp.asarray(xt), jp, jcache,
                                           n_heads=H,
                                           compute_dtype=jnp.float32)
        got, cache = xlstm.slstm_decode(torch.from_numpy(xt), p, cache,
                                        n_heads=H)
        assert_allclose(got.numpy(), np.asarray(want), **TOL)
        _close(cache["state"], jcache["state"])


# -- the chunk rule -----------------------------------------------------------

@pytest.mark.parametrize("mixer,L", [("mamba", 600), ("mamba", 1000),
                                     ("mlstm", 300), ("mlstm", 520)])
def test_both_packages_refuse_a_prompt_the_chunks_do_not_divide(mixer, L):
    """The JAX package asserts ``L % min(chunk, L) == 0`` (512 for Mamba,
    256 for mLSTM); the port raises ``ValueError``, in the block and at
    ``ServeEngine.submit``."""
    d = 8
    x = _x((1, L, d), 0)
    if mixer == "mamba":
        jp, p = _params(jssm.init_mamba(
            jax.random.PRNGKey(0), d, d_state=4, d_conv=4, expand=2,
            dt_rank=2, stack=(), dtype=jnp.float32))
        with pytest.raises(AssertionError):
            jssm.mamba_forward(jnp.asarray(x), jp, d_state=4,
                               compute_dtype=jnp.float32)
        with pytest.raises(ValueError, match=f"{L} tokens"):
            ssm.mamba_forward(torch.from_numpy(x), p, d_state=4)
        arch = "jamba-v0.1-52b"
    else:
        jp, p = _params(jxlstm.init_mlstm(jax.random.PRNGKey(0), d, 2,
                                          expand=2, stack=(),
                                          dtype=jnp.float32))
        with pytest.raises(AssertionError):
            jxlstm.mlstm_forward(jnp.asarray(x), jp, n_heads=2,
                                 compute_dtype=jnp.float32)
        with pytest.raises(ValueError, match=f"{L} tokens"):
            xlstm.mlstm_forward(torch.from_numpy(x), p, n_heads=2)
        arch = "xlstm-125m"
    model = tf.init_model(get_smoke_config(arch), device="cpu")
    eng = ServeEngine(model, slots=1, cache_len=2048, device="cpu")
    with pytest.raises(ValueError, match=f"{L} tokens"):
        eng.submit(np.zeros(L, np.int32), 1)
    assert not eng.queue
