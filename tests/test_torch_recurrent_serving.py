"""jamba-v0.1-52b and xlstm-125m through the JAX package's and the port's engines.

Their smoke configs (jamba: 8 layers, 7 Mamba and one attention, MoE on
every other layer; xlstm: 5 mLSTM and one sLSTM, no FFN), with the JAX
package's weights carried across by ``params_from_jax``, through both
``ServeEngine``s on prompts of 1, 2, 5 and 12 tokens: greedy tokens
identical, and every prefill's and every tick's logits within 1e-4
(xlstm's smoke model repeats its greedy token, so tokens alone would
hide a difference). The 1- and 2-token prompts run the JAX engine's
conv-tail rule (F6 in ROADMAP.md). The port runs on the CPU, with one
torch thread.
"""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro.configs.base import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import layers as jlayers, transformer as jtf  # noqa: E402
from repro.serving.engine import ServeEngine as JaxEngine  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.serving.engine import ServeEngine, _leaves  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", params=("jamba-v0.1-52b", "xlstm-125m"))
def model(request):
    torch.set_num_threads(1)
    arch = request.param
    jcfg = jax_smoke_config(arch).scaled(remat=False)
    cfg = get_smoke_config(arch).scaled(remat=False)
    params = jlayers.split_annotated(
        jtf.init_model(jcfg, jax.random.PRNGKey(0)))[0]
    tree = jax.tree_util.tree_map(np.asarray, params)
    return jcfg, params, cfg, params_from_jax(cfg, tree, device="cpu")


def test_engines_match_on_short_and_longer_prompts(model, monkeypatch):
    """Prompts of 1, 2, 5 and 12 tokens, 6 greedy tokens each, on two
    slots (each slot reused once). Every prefill's last logits and every
    tick's logits (all slots, the idle ones too) agree within 1e-4."""
    jcfg, params, cfg, torch_model = model
    logs = {"jax": [], "port": []}

    def recorder(log, fn):
        def call(*args):
            out = fn(*args)
            log.append(np.array(out[0]))
            return out
        return call

    monkeypatch.setattr(jtf, "prefill", recorder(logs["jax"], jtf.prefill))
    monkeypatch.setattr(tf, "prefill", recorder(logs["port"], tf.prefill))
    monkeypatch.setattr(tf, "decode_step",
                        recorder(logs["port"], tf.decode_step))
    jeng = JaxEngine(jcfg, params, slots=2, cache_len=64)
    jeng._decode = recorder(logs["jax"], jeng._decode)
    eng = ServeEngine(torch_model, slots=2, cache_len=64, device="cpu")
    for n in (1, 2, 5, 12):
        prompt = (np.arange(n) * 7 + n) % cfg.vocab_size
        assert jeng.submit(prompt, 6) == eng.submit(prompt, 6)
    want, got = jeng.run(), eng.run()
    assert got == want and all(len(v) == 6 for v in got.values())
    assert len(logs["port"]) == len(logs["jax"]) > 4
    for a, b in zip(logs["port"], logs["jax"]):
        assert_allclose(a, b, **TOL)


def test_slot_state_after_prefill_is_the_requests_own(model):
    """After a slot is reused, every cache leaf of the slot holds what a
    prefill of that request alone gives (conv tails padded at the end)."""
    _, _, cfg, torch_model = model
    eng = ServeEngine(torch_model, slots=2, cache_len=64, device="cpu")
    eng.submit(np.arange(9) % cfg.vocab_size, 3)
    eng.submit(np.arange(4) % cfg.vocab_size, 1)
    eng.submit(np.array([3, 1]), 2)
    eng._admit({})
    eng._tick({})
    eng._admit({})                 # the 2-token prompt takes slot 1
    _, alone = tf.prefill(torch_model, torch.tensor([[3, 1]]))
    for c, a in zip(eng.caches, alone):
        for got, want in zip(_leaves(c), _leaves(a)):
            n = want.shape[1]
            assert torch.equal(got[1, :n], want[0])
            assert not got[1, n:].any()
