"""The port's dense transformer against the JAX package's.

h2o-danube-1.8b's smoke config (2 layers, d = 64, 4/2 heads, window 32,
float32) with the JAX package's own weights carried across by
``params_from_jax``; inputs come from NumPy with a seed. The port runs
on the CPU, so its norms and attention take the kernels' plain
versions. Every comparison holds to 1e-4.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro.configs import base as jax_configs  # noqa: E402
from repro.models import layers as jlayers, transformer as jtf  # noqa: E402
from repro_torch.configs.base import BlockSpec, get_config, get_smoke_config  # noqa: E402
from repro_torch.models import layers, ssm, transformer as tf, xlstm  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "h2o-danube-1.8b"


@pytest.fixture(scope="module")
def lm():
    torch.set_num_threads(1)
    jcfg = jax_configs.get_smoke_config(ARCH).scaled(remat=False)
    params = jlayers.split_annotated(
        jtf.init_model(jcfg, jax.random.PRNGKey(0)))[0]
    tree = jax.tree_util.tree_map(np.asarray, params)
    cfg = get_smoke_config(ARCH).scaled(remat=False)
    return jcfg, params, cfg, params_from_jax(cfg, tree, device="cpu")


def test_configs_are_the_jax_packages():
    for arch in jax_configs.ARCH_IDS:
        for get, jget in ((get_config, jax_configs.get_config),
                          (get_smoke_config, jax_configs.get_smoke_config)):
            assert dataclasses.asdict(get(arch)) == \
                dataclasses.asdict(jget(arch))
    full = get_config(ARCH)
    assert (full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
            full.resolved_head_dim, full.d_ff, full.vocab_size,
            full.pattern[0].window) == (24, 2560, 32, 8, 80, 6912, 32000, 4096)


def test_apply_rope_matches():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = rng.integers(0, 5000, size=(2, 9))
    got = layers.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)
    got = layers.apply_rope(torch.from_numpy(x), torch.arange(9), 500.0)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.arange(9)[None], 500.0)
    assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_ffn_matches(lm):
    jcfg, params, cfg, model = lm
    x = np.random.default_rng(1).standard_normal((2, 5, 64)).astype(np.float32)
    layer = 1
    jffn = jax.tree_util.tree_map(lambda a: a[layer], params["blocks"][0]["ffn"])
    want = jlayers.ffn(jnp.asarray(x), jffn, jnp.float32)
    got = model.blocks[layer].ffn(torch.from_numpy(x))
    assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _prefill_both(lm, tokens):
    jcfg, params, cfg, model = lm
    jlogits, jcaches = jtf.prefill(jcfg, params, jnp.asarray(tokens))
    logits, caches = tf.prefill(model, torch.from_numpy(tokens).long())
    return jlogits, jcaches, logits, caches


@pytest.mark.parametrize("S", [11, 45], ids=["inside_window", "rolled_ring"])
def test_prefill_logits_and_caches_match(lm, S):
    """Logits of the last position and every layer's k, v; at S = 45 the
    window-32 layers keep the last 32 rows rolled into ring order."""
    tokens = np.random.default_rng(S).integers(0, 256, size=(2, S))
    jlogits, jcaches, logits, caches = _prefill_both(lm, tokens)
    assert logits.shape == (2, 1, 256)
    assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    assert len(caches) == 2
    for i, c in enumerate(caches):
        assert c["k"].shape == (2, min(S, 32), 2, 16)
        for name in ("k", "v"):
            assert_allclose(c[name].numpy(), np.asarray(jcaches[0][name][i]),
                            **TOL)


def test_decode_step_matches_over_a_wrapping_ring(lm):
    """Prefill 30 tokens, then decode 40 steps in an engine-sized cache:
    the window-32 ring wraps at step 2 and every step's logits agree."""
    jcfg, params, cfg, model = lm
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 256, size=(2, 30))
    jlogits, jcaches, logits, caches = _prefill_both(lm, tokens)
    pad = [(0, 0), (0, 0), (0, 2), (0, 0), (0, 0)]
    jcaches = jax.tree_util.tree_map(lambda a: jnp.pad(a, pad), jcaches)
    ring = tf.init_caches(cfg, 2, 64, device="cpu")
    for c, new in zip(ring, caches):
        for name in ("k", "v"):
            assert c[name].shape[1] == 32
            c[name][:, :30] = new[name]
    step = jax.jit(lambda p, c, t, q: jtf.decode_step(jcfg, p, c, t, q))
    pos = np.array([30, 30])
    for _ in range(40):
        nxt = rng.integers(0, 256, size=(2, 1))
        jlogits, jcaches = step(params, jcaches, jnp.asarray(nxt),
                                jnp.asarray(pos, jnp.int32))
        logits, ring = tf.decode_step(model, ring, torch.from_numpy(nxt),
                                      torch.from_numpy(pos))
        assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        pos = pos + 1
    for i, c in enumerate(ring):
        assert_allclose(c["k"].numpy(), np.asarray(jcaches[0]["k"][i]), **TOL)


def test_init_model_draws_the_jax_scales():
    cfg = get_smoke_config(ARCH)
    model = tf.init_model(cfg, torch.Generator().manual_seed(3), device="cpu")
    again = tf.init_model(cfg, torch.Generator().manual_seed(3), device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(model.parameters(), again.parameters()))
    attn = model.blocks[0].mixer
    # the JAX package's fan-in of wq is its padded head count (16 here)
    assert attn.wq.shape == (64, 4 * 16)
    assert abs(float(attn.wq.std()) - 16 ** -0.5) < 0.05
    assert abs(float(model.unembed.std()) - 64 ** -0.5) < 0.02
    logits, _ = tf.prefill(model, torch.zeros(1, 3, dtype=torch.long))
    assert torch.isfinite(logits).all()


def test_blocks_of_later_slices_raise():
    """The blocks of the later slices are ported: Jamba's ``mamba`` and
    xLSTM's ``mlstm`` / ``slstm`` configs build (``ffn == "none"`` blocks
    without a ``norm2``); a mixer or FFN the zoo does not have still
    raises ``ValueError``."""
    for arch, forward in (("xlstm-125m", xlstm.mlstm_forward),
                          ("jamba-v0.1-52b", ssm.mamba_forward)):
        cfg = get_smoke_config(arch)
        model = tf.init_model(cfg, device="cpu")
        assert len(model.blocks) == cfg.num_layers
        assert model.blocks[0].mixer.fns[0] is forward
        assert (model.blocks[0].norm2 is None) == \
            (cfg.pattern[0].ffn == "none")
    cfg = get_smoke_config(ARCH)
    for spec in (BlockSpec(mixer="rwkv"), BlockSpec(ffn="glu")):
        with pytest.raises(ValueError, match="unknown block"):
            tf.init_model(cfg.scaled(pattern=(spec,)), device="cpu")
