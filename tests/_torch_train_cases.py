"""The training parity checks shared by ``tests/test_torch_train.py``
and ``tests/test_torch_train_recurrent.py`` (the port's training path
against the JAX package at smoke size; the test files say what each
check holds and at what tolerance)."""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import layers as jlayers, transformer as jtf  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.models import attention, transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as steps  # noqa: E402

LOSS_TOL = 1e-5     # train_loss, absolute
GRAD_TOL = 1e-4     # every gradient, relative to its largest JAX entry
PARAM_TOL = 1e-5    # parameters after three AdamW steps, absolute
# (batch, sequence, prefix embeddings) of each smoke config's batch
ARCHS = {"granite-moe-3b-a800m": (2, 24, 0),
         "h2o-danube-1.8b": (2, 48, 0),        # past the window of 32
         "jamba-v0.1-52b": (2, 16, 0),
         "xlstm-125m": (2, 16, 0),
         "llava-next-34b": (2, 12, 4)}         # 4 prefix embeddings
OPT = opt.AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=10)


def _unit_scores(params, cfg):
    """The JAX tree with wq, wk at their true fan-in (as
    ``tests/test_torch_zoo.py`` scales them)."""
    hp = attention.padded_heads(cfg.num_heads)
    blocks = []
    for blk in params["blocks"]:
        mix = dict(blk["mixer"])
        if "wq" in mix:
            mix["wq"] = mix["wq"] * (hp / cfg.d_model) ** 0.5
            mix["wk"] = mix["wk"] * (cfg.num_kv_heads / cfg.d_model) ** 0.5
        blocks.append({**blk, "mixer": mix})
    return {**params, "blocks": type(params["blocks"])(blocks)}


def jax_leaf(tree, name: str, cfg) -> np.ndarray:
    """The slice of the JAX tree (params or grads) that the port's
    parameter ``name`` holds: the layer's period of a stacked leaf, the
    real query heads and experts, in the port's 2-D attention layout."""
    if name in ("embed", "unembed"):
        return np.asarray(tree[name]["table"])
    if name == "final_norm.scale":
        return np.asarray(tree["final_norm"]["scale"])
    m = re.fullmatch(r"blocks\.(\d+)\.(.+)", name)
    p, j = divmod(int(m.group(1)), len(cfg.pattern))
    blk, rest = tree["blocks"][j], m.group(2).split(".")
    h, d, E = cfg.num_heads, cfg.d_model, cfg.num_experts
    if rest[0] in ("norm1", "norm2"):
        return np.asarray(blk[rest[0]]["scale"][p])
    if rest[0] == "mixer" and rest[1] == "w":
        return np.asarray(blk["mixer"][rest[2]][p])
    if rest[0] == "mixer":
        a = np.asarray(blk["mixer"][rest[1]][p])
        if rest[1] == "wq":
            return a[:, :h].reshape(d, -1)
        if rest[1] == "wo":
            return a[:h].reshape(-1, d)
        return a.reshape(d, -1)
    ffn = blk["ffn"]
    if rest[1] == "shared":
        return np.asarray(ffn["shared"][rest[2]][p])
    a = np.asarray(ffn[rest[1]][p])
    if E and "router" in ffn:
        return a[:, :E] if rest[1] == "router" else a[:E]
    return a


def make_case(arch: str):
    """(arch, the JAX package's jitted value_and_grad of train_loss, the
    port's config, the JAX parameters, the NumPy batch, the JAX batch)."""
    torch.set_num_threads(1)
    B, S, P = ARCHS[arch]
    jcfg = jax_smoke_config(arch).scaled(remat=False)
    cfg = get_smoke_config(arch).scaled(remat=False)
    params = _unit_scores(jlayers.split_annotated(
        jtf.init_model(jcfg, jax.random.PRNGKey(0)))[0], cfg)
    rng = np.random.default_rng(len(arch))
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
             "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    if P:
        batch["prefix_embeds"] = rng.standard_normal(
            (B, P, cfg.d_model)).astype(np.float32)
    jbatch = {k: jnp.asarray(v.astype(np.int32) if v.dtype.kind == "i"
                             else v) for k, v in batch.items()}
    value_and_grad = jax.jit(jax.value_and_grad(
        functools.partial(jtf.train_loss, jcfg)))
    return arch, value_and_grad, cfg, params, batch, jbatch


def _model(cfg, params):
    tree = jax.tree_util.tree_map(np.asarray, params)
    return params_from_jax(cfg, tree, device="cpu", trainable=True)


def _grads(model, batch):
    for p in model.parameters():
        p.grad = None
    loss = tf.train_loss(model, steps.to_batch(batch, "cpu"))
    loss.backward()
    return loss, {n: p.grad.clone() for n, p in model.named_parameters()}


def check_loss_and_every_gradient_match_jax(case):
    arch, value_and_grad, cfg, params, batch, jbatch = case
    jloss, jgrads = value_and_grad(params, jbatch)
    model = _model(cfg, params)
    loss, grads = _grads(model, batch)
    loss = float(loss)
    assert abs(loss - float(jloss)) <= LOSS_TOL, (arch, loss, float(jloss))
    assert len(grads) == len(list(model.parameters()))
    # the eval step is the same loss without autograd, and the prefill
    # step the model's prefill
    assert float(steps.make_eval_step(cfg)(model, batch)) == loss
    tb = steps.to_batch(batch, "cpu")
    logits, _ = steps.make_prefill_step(cfg)(model, batch)
    want, _ = tf.prefill(model, tb["tokens"], tb.get("prefix_embeds"))
    assert torch.equal(logits, want)
    for name, g in grads.items():
        want = jax_leaf(jgrads, name, cfg)
        assert g.shape == want.shape, name
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(g.numpy() - want).max()) / scale
        assert err <= GRAD_TOL, (arch, name, err)


def check_three_adamw_steps_match_jax(case):
    arch, value_and_grad, cfg, params, batch, jbatch = case
    update = jax.jit(functools.partial(jopt.apply_updates, OPT_J))
    jparams, jstate = params, jopt.init_opt_state(params)
    model = _model(cfg, params)
    state = opt.init_opt_state(dict(model.named_parameters()))
    train_step = steps.make_train_step(cfg, OPT)
    for _ in range(3):
        jloss, jgrads = value_and_grad(jparams, jbatch)
        jparams, jstate, _ = update(jparams, jgrads, jstate)
        model, state, met = train_step(model, state, batch)
        assert abs(float(met["loss"]) - float(jloss)) <= LOSS_TOL
    assert state.step == 3 and int(jstate.step) == 3
    for name, p in model.named_parameters():
        err = float(np.abs(p.detach().numpy() -
                           jax_leaf(jparams, name, cfg)).max())
        assert err <= PARAM_TOL, (arch, name, err)


OPT_J = jopt.AdamWConfig(**{f: getattr(OPT, f) for f in
                            OPT.__dataclass_fields__})


def check_remat_gives_the_same_bits(case):
    """Each block checkpointed (``cfg.remat``): the recomputed forward
    routes the same tokens to the same experts, so the loss and every
    gradient are the plain path's bits."""
    arch, _, cfg, params, batch, _ = case
    plain = _model(cfg, params)
    remat = _model(cfg.scaled(remat=True), params)
    l0, g0 = _grads(plain, batch)
    l1, g1 = _grads(remat, batch)
    assert torch.equal(l0, l1), arch
    for name in g0:
        assert torch.equal(g0[name], g1[name]), (arch, name)


def check_decay_follows_the_jax_tree(case):
    """AdamW decays what the JAX package decays: every leaf of two or
    more dimensions of its tree, whose block leaves carry the layer axis;
    so every block weight and the embeddings, and not the final norm."""
    arch, _, cfg, params, batch, _ = case
    model = _model(cfg, params)
    for name, decays in model.decay_mask().items():
        jdim = 1 + jax_leaf(params, name, cfg).ndim \
            if name.startswith("blocks.") else jax_leaf(params, name, cfg).ndim
        assert decays == (jdim >= 2), name
