"""The frontends' prefix embeddings: musicgen-large and llava-next-34b.

Both configs' frontends are stubs in the JAX package: the caller passes
the prefix embeddings (audio frames, image patches; llava's smoke config
has 16), which ``prefill`` places before the token embeddings. Their
smoke configs, with the JAX package's weights carried across by
``params_from_jax``, prefill the same NumPy prefix and tokens in both
packages: the last position's logits and every layer's k, v within 1e-4,
then four decode steps after the prefix. The port runs on the CPU, with
one torch thread.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro.configs.base import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import layers as jlayers, transformer as jtf  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", params=("musicgen-large", "llava-next-34b"))
def model(request):
    torch.set_num_threads(1)
    arch = request.param
    jcfg = jax_smoke_config(arch).scaled(remat=False)
    cfg = get_smoke_config(arch).scaled(remat=False)
    params = jlayers.split_annotated(
        jtf.init_model(jcfg, jax.random.PRNGKey(0)))[0]
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, params, cfg, params_from_jax(cfg, tree, device="cpu")


@pytest.mark.parametrize("n_prefix", [0, 16])
def test_prefill_with_prefix_embeddings_matches(model, n_prefix):
    jcfg, params, cfg, torch_model = model
    assert tf.check_supported(cfg) is None and cfg.frontend is not None
    rng = np.random.default_rng(n_prefix)
    tokens = rng.integers(0, cfg.vocab_size, size=(2, 12))
    prefix = rng.standard_normal((2, n_prefix, cfg.d_model)).astype(
        np.float32) if n_prefix else None
    jlogits, jcaches = jax.jit(functools.partial(jtf.prefill, jcfg))(
        params, jnp.asarray(tokens),
        None if prefix is None else jnp.asarray(prefix))
    logits, caches = tf.prefill(
        torch_model, torch.from_numpy(tokens),
        None if prefix is None else torch.from_numpy(prefix))
    assert logits.shape == (2, 1, cfg.vocab_size)
    assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    for i, c in enumerate(caches):
        assert c["k"].shape[1] == n_prefix + 12
        for name in ("k", "v"):
            assert_allclose(c[name].numpy(), np.asarray(jcaches[0][name][i]),
                            **TOL)
    # decode after the prefix: the ring holds prefix and prompt rows
    ring = tf.init_caches(cfg, 2, 40, device="cpu")
    for c, new in zip(ring, caches):
        for name in ("k", "v"):
            c[name][:, :n_prefix + 12] = new[name]
    pad = [(0, 0), (0, 0), (0, 40 - n_prefix - 12), (0, 0), (0, 0)]
    jcaches = jax.tree_util.tree_map(lambda a: jnp.pad(a, pad), jcaches)
    step = jax.jit(lambda p, c, t, q: jtf.decode_step(jcfg, p, c, t, q))
    pos = np.full(2, n_prefix + 12)
    for _ in range(4):
        nxt = rng.integers(0, cfg.vocab_size, size=(2, 1))
        jlogits, jcaches = step(params, jcaches, jnp.asarray(nxt),
                                jnp.asarray(pos, jnp.int32))
        logits, ring = tf.decode_step(torch_model, ring,
                                      torch.from_numpy(nxt),
                                      torch.from_numpy(pos))
        assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        pos = pos + 1
