"""The zoo configs the port accepts, against the kernels and the JAX package.

``check_supported`` accepts every config in ``ARCH_IDS``, and each with
an attention mixer must have head shapes the attention kernels compile at
its full width: the head dim in flash attention's ``HEAD_DIMS`` and a head
shape the decode kernel takes. The four accepted configs that the model and serving tests of
h2o-danube-1.8b and granite-moe-3b-a800m do not reach (gemma3-12b's 5:1
window pattern and tied embeddings, granite-20b's single kv head,
phi4-mini-3.8b, llama4-maverick-400b-a17b's dense/MoE interleave with a
shared expert) run at smoke size with the JAX package's weights carried
across by ``params_from_jax``: logits within 1e-4 and greedy tokens
identical to the JAX engine's. The port runs on the CPU, through the
kernels' plain versions.

The weights are the JAX package's init with wq and wk scaled to their
true fan-in (F3 in ROADMAP.md): at the init's own scale the scores are
all but one-hot, and gemma3-12b's six smoke layers carry a rounding-level
difference to 8e-4 in the logits; scaled, every config agrees to about
1e-5.
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
from repro.serving.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs.base import ARCH_IDS, get_config, get_smoke_config  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models import attention, transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
# the accepted configs no other test of the port runs
ARCHS = ("gemma3-12b", "granite-20b", "phi4-mini-3.8b",
         "llama4-maverick-400b-a17b")
ACCEPTED = {"h2o-danube-1.8b", "granite-moe-3b-a800m", *ARCHS, "jamba-v0.1-52b",
            "xlstm-125m", "musicgen-large", "llava-next-34b"}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_accepted_configs_have_head_shapes_the_kernels_compile(arch):
    """Head shapes are checked for configs with an attention mixer only:
    xlstm-125m's d_model / num_heads (192) heads no attention."""
    cfg = get_config(arch)
    tf.check_supported(cfg)
    assert arch in ACCEPTED
    if not any(s.mixer in ("attn", "attn_window") for s in cfg.pattern):
        return
    H, KV, D = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    assert D in fa.HEAD_DIMS, f"{arch}: prefill head dim {D}"
    assert da.kernel_takes(H, KV, D), f"{arch}: decode {H}/{KV} x {D}"


def _unit_scores(params, cfg):
    """The JAX tree with wq, wk at their true fan-in, 1/sqrt(d_model)
    (``chip_smoke.unit_scores`` on the port's side)."""
    hp = attention.padded_heads(cfg.num_heads)
    blocks = []
    for blk in params["blocks"]:
        mix = dict(blk["mixer"])
        mix["wq"] = mix["wq"] * (hp / cfg.d_model) ** 0.5
        mix["wk"] = mix["wk"] * (cfg.num_kv_heads / cfg.d_model) ** 0.5
        blocks.append({**blk, "mixer": mix})
    return {**params, "blocks": type(params["blocks"])(blocks)}


@pytest.fixture(scope="module", params=ARCHS)
def zoo(request):
    torch.set_num_threads(1)
    arch = request.param
    jcfg = jax_smoke_config(arch).scaled(remat=False)
    cfg = get_smoke_config(arch).scaled(remat=False)
    params = _unit_scores(jlayers.split_annotated(
        jtf.init_model(jcfg, jax.random.PRNGKey(0)))[0], cfg)
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, params, cfg, params_from_jax(cfg, tree, device="cpu")


def test_prefill_logits_and_caches_match(zoo):
    """45 tokens: past gemma3-12b's window of 32, so its window layers
    keep the last 32 rows rolled into ring order."""
    jcfg, params, cfg, model = zoo
    tokens = np.random.default_rng(5).integers(0, 256, size=(2, 45))
    jlogits, jcaches = jax.jit(functools.partial(jtf.prefill, jcfg))(
        params, jnp.asarray(tokens))
    logits, caches = tf.prefill(model, torch.from_numpy(tokens).long())
    assert logits.shape == (2, 1, 256)
    assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
    n_pat = len(cfg.pattern)
    for i, c in enumerate(caches):
        p, j = divmod(i, n_pat)
        for name in ("k", "v"):
            assert_allclose(c[name].numpy(),
                            np.asarray(jcaches[j][name][p]), **TOL)


def test_decode_steps_match(zoo):
    """Prefill 30 tokens, then 12 decode steps of two rows at different
    depths in an engine-sized cache (gemma3-12b's window ring wraps)."""
    jcfg, params, cfg, model = zoo
    rng = np.random.default_rng(6)
    tokens = rng.integers(0, 256, size=(2, 30))
    jlogits, jcaches = jax.jit(functools.partial(jtf.prefill, jcfg))(
        params, jnp.asarray(tokens))
    logits, caches = tf.prefill(model, torch.from_numpy(tokens).long())
    ring = tf.init_caches(cfg, 2, 48, device="cpu")
    for c, new in zip(ring, caches):
        for name in ("k", "v"):
            c[name][:, :30] = new[name]
    jcaches = tuple(
        {n: jnp.pad(a, [(0, 0), (0, 0), (0, ring[j][n].shape[1] - 30),
                        (0, 0), (0, 0)]) for n, a in c.items()}
        for j, c in enumerate(jcaches))
    step = jax.jit(lambda p, c, t, q: jtf.decode_step(jcfg, p, c, t, q))
    pos = np.array([30, 26])
    for _ in range(12):
        nxt = rng.integers(0, 256, size=(2, 1))
        jlogits, jcaches = step(params, jcaches, jnp.asarray(nxt),
                                jnp.asarray(pos, jnp.int32))
        logits, ring = tf.decode_step(model, ring, torch.from_numpy(nxt),
                                      torch.from_numpy(pos))
        assert_allclose(logits.numpy(), np.asarray(jlogits), **TOL)
        pos = pos + 1


def test_greedy_tokens_match_the_jax_engine(zoo):
    """Three requests on two slots: a 60-token prompt that runs to the
    ring's end, a slot that is reused, and a short prompt."""
    jcfg, params, cfg, model = zoo
    reqs = [(np.arange(60) % 256, 16), (np.array([1, 2, 3]), 2),
            (np.array([5, 9, 2, 7, 1]), 8)]
    jeng = JaxEngine(jcfg, params, slots=2, cache_len=64)
    eng = ServeEngine(model, slots=2, cache_len=64, device="cpu")
    for prompt, max_new in reqs:
        assert jeng.submit(prompt, max_new) == eng.submit(prompt, max_new)
    want, got = jeng.run(), eng.run()
    assert got == want
    assert {r: q.truncated for r, q in eng.requests.items()} == \
        {r: q.truncated for r, q in jeng.requests.items()}
