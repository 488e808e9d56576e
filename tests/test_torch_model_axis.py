"""The port's "model" axis over ``torch.distributed``, held to the JAX
package's unsharded functions.

Gloo ranks (spawned as processes, ``tests/_torch_tp_worker.py``, joined
through a ``file://`` store under the test's directory) each build their
slice of a smoke model from the JAX package's own parameters
(``params_from_jax(..., mesh=make_local_mesh("cpu", model=m))``): the
padded heads and experts cut by the port's placement. Three models,
each cut to exercise one side of the placement at m = 2 (jamba-v0.1-52b
in ``tests/test_torch_model_axis_hybrid.py``, which runs this file's
checks):

  * h2o-danube-1.8b with 16 heads on 4 kv heads: no padded head, so the
    kv heads are split too (``attention.kv_split``);
  * granite-moe-3b-a800m with 16 experts, so both ranks hold real
    experts, and a shared expert, split like the FFN (its partial sums
    join the experts' in one sum); its 4 heads are padded to 16, so rank
    1's heads are all dead and the kv heads are replicated; each block
    rematerialised, so its collectives run again in the backward;
  * jamba-v0.1-52b (Mamba's d_inner split, 4 experts padded to 16) with
    a vocab of 255, which does not divide and stays whole (a recorded
    fallback).

Checked at m = 2: ``train_loss`` within 1e-5 and every gradient within
1e-4 of its largest JAX entry (the ranks' shards joined in rank order,
against the JAX tree with its padded heads and experts); the prefill's
logits and 8 decode ticks' over caches split by sequence (rings of 32
or 16 rows, half a rank, each wrapped: a prompt past the window rolled
into its ring, ticks past the ring's end written by the rank that holds
the row) within 2e-5 of the JAX package's prefill and ``decode_step``;
no differing route against the port's one-process model; and every
tensor replicated over "model" (the loss, each replicated gradient, the
logits) with the same bits on both ranks. And
one training step of data 2 x model 2 (4 ranks, FSDP over "data": each
rank holds its model shard's slice over "data") against the JAX train
step on the global batch with 2 MoE groups (the program of
``tests/test_torch_data_parallel.py``): loss, gradients, and the
parameters after an AdamW step (the slices joined over "data", then the
shards over "model"), every rank's replicated parameters with the same
bits as its model group's and its data group's.
"""
import functools
import pickle
import re

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_tp_worker import spawn  # noqa: E402
from _torch_train_cases import (  # noqa: E402
    GRAD_TOL, LOSS_TOL, PARAM_TOL, _unit_scores)
from repro.configs.base import (  # noqa: E402
    get_smoke_config as jax_smoke_config)
from repro.models import layers as jlayers  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.models import moe, transformer as tf  # noqa: E402
from repro_torch.models.convert import params_from_jax  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as steps  # noqa: E402

DECODE_TOL = 2e-5       # float32 attention, tests/test_kernels.py
TICKS = 8
# arch -> (the smoke config's overrides, both packages', the batch, and
# the served prompt's length and ring rows). Every ring wraps: h2o's
# prompt of 44 is longer than its window of 32, so the prefill rolls it
# into the ring, and its ticks write rows 12 .. 19 of both ranks; the
# others' ticks run past their ring of 16 (positions 12 .. 19), writing
# rows 12 .. 15 of rank 1, then rows 0 .. 3 of rank 0.
CASES = {
    "h2o-danube-1.8b": ({"num_heads": 16, "num_kv_heads": 4,
                         "head_dim": 16}, (2, 48), (44, 32)),
    "granite-moe-3b-a800m": ({"num_experts": 16, "num_shared_experts": 1},
                             (2, 24), (12, 16)),
    "jamba-v0.1-52b": ({"vocab_size": 255}, (2, 16), (12, 16)),
}
REMAT = {"granite-moe-3b-a800m"}
OPT = opt.AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=10)
OPT_J = jopt.AdamWConfig(lr=1e-4, warmup_steps=1, total_steps=10)


def _case(arch):
    scaled, (B, S), _ = CASES[arch]
    jcfg = jax_smoke_config(arch).scaled(remat=False, **scaled)
    cfg = get_smoke_config(arch).scaled(remat=arch in REMAT, **scaled)
    params = _unit_scores(jlayers.split_annotated(
        jtf.init_model(jcfg, jax.random.PRNGKey(0)))[0], cfg)
    rng = np.random.default_rng(len(arch))
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
             "labels": rng.integers(0, cfg.vocab_size, (B, S))}
    return jcfg, cfg, params, batch


def _job(tmp, arch, params, batch, model, **extra):
    tree = jax.tree_util.tree_map(np.asarray, params)
    with open(tmp / "params.pkl", "wb") as f:
        pickle.dump(tree, f)
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
               tmp / "batch.pt")
    scaled = dict(CASES[arch][0], remat=arch in REMAT)
    return {"init": f"file://{tmp}/store_{model}", "arch": arch,
            "scaled": scaled, "model": model,
            "params": str(tmp / "params.pkl"),
            "batch": str(tmp / "batch.pt"),
            "out": str(tmp / ("out_" + str(model) + "_{rank}.pt")), **extra}


def jax_full(tree, name: str, cfg) -> np.ndarray:
    """The JAX leaf the port's parameter ``name`` is a shard of, in the
    port's layout: the layer's period, the padded heads and experts
    kept, the router over the real experts."""
    if name in ("embed", "unembed"):
        return np.asarray(tree[name]["table"])
    if name == "final_norm.scale":
        return np.asarray(tree["final_norm"]["scale"])
    m = re.fullmatch(r"blocks\.(\d+)\.(.+)", name)
    p, j = divmod(int(m.group(1)), len(cfg.pattern))
    blk, rest = tree["blocks"][j], m.group(2).split(".")
    d = cfg.d_model
    if rest[0] in ("norm1", "norm2"):
        return np.asarray(blk[rest[0]]["scale"][p])
    if rest[0] == "mixer" and rest[1] == "w":
        return np.asarray(blk["mixer"][rest[2]][p])
    if rest[0] == "mixer":
        a = np.asarray(blk["mixer"][rest[1]][p])
        return a.reshape(-1, d) if rest[1] == "wo" else a.reshape(d, -1)
    ffn = blk["ffn"]
    if rest[1] == "shared":
        return np.asarray(ffn["shared"][rest[2]][p])
    a = np.asarray(ffn[rest[1]][p])
    return a[:, :cfg.num_experts] if rest[1] == "router" else a


def joined(name: str, parts, shape) -> torch.Tensor:
    """The model ranks' shards of ``name`` joined in rank order (the one
    dim that differs from the whole ``shape``; Mamba's in_proj a half at
    a time)."""
    if tuple(parts[0].shape) == tuple(shape):
        return parts[0]
    if name.endswith("mixer.w.in_proj"):
        halves = [p.chunk(2, dim=-1) for p in parts]
        return torch.cat([h[0] for h in halves] + [h[1] for h in halves],
                         dim=-1)
    dim = next(i for i, (a, b) in enumerate(zip(parts[0].shape, shape))
               if a != b)
    return torch.cat(parts, dim=dim)


def _rel(got: torch.Tensor, want: np.ndarray) -> float:
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got.numpy() - want).max()) / scale


def _jax_decode(jcfg, params, tokens, ticks, cache):
    """The JAX package's prefill logits and each decode tick's, the
    prefill's caches padded into rings of ``cache`` rows (a window
    layer's prompt past its window is already one, rolled by the JAX
    prefill as the port rolls it)."""
    jlogits, jcaches = jtf.prefill(jcfg, params, jnp.asarray(tokens))

    def ring(a):
        if a.ndim != 5:
            return a
        assert a.shape[2] <= cache, a.shape
        return jnp.pad(a, [(0, 0), (0, 0), (0, cache - a.shape[2]), (0, 0),
                           (0, 0)])
    jcaches = jax.tree_util.tree_map(ring, jcaches)
    step = jax.jit(lambda p, c, t, q: jtf.decode_step(jcfg, p, c, t, q))
    pos = np.full(tokens.shape[0], tokens.shape[1], np.int32)
    out = []
    for t in ticks:
        lg, jcaches = step(params, jcaches, jnp.asarray(t.numpy()),
                           jnp.asarray(pos))
        out.append(np.asarray(lg))
        pos = pos + 1
    return np.asarray(jlogits), out


def _one_process_routes(cfg, params, batch, monkeypatch) -> list:
    routes, real = [], moe.route

    def route(*args, **kwargs):
        res = real(*args, **kwargs)
        routes.append(res[3].clone())
        return res

    monkeypatch.setattr(moe, "route", route)
    model = params_from_jax(cfg, jax.tree_util.tree_map(np.asarray, params),
                            "cpu", trainable=True)
    tf.train_loss(model, steps.to_batch(batch, "cpu")).backward()
    monkeypatch.setattr(moe, "route", real)
    return routes


def check_two_model_ranks_match_jax(arch, tmp_path, monkeypatch):
    jcfg, cfg, params, batch = _case(arch)
    prompt, cache = CASES[arch][2]
    rng = np.random.default_rng(7)
    ticks = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 1)))
             for _ in range(TICKS)]
    torch.save(ticks, tmp_path / "ticks.pt")
    job = _job(tmp_path, arch, params, batch, 2, grads=True, decode=True,
               prompt=prompt, cache_len=cache,
               ticks=str(tmp_path / "ticks.pt"))
    ranks = spawn(tmp_path, 2, job)
    r0 = ranks[0]
    assert [r["model_rank"] for r in ranks] == [0, 1]
    if arch == "jamba-v0.1-52b":
        assert r0["fallbacks"] == [{"axis": "kv_heads", "mesh_axes":
                                    ["model"], "count": 2, "dims": [2]},
                                   {"axis": "vocab", "mesh_axes": ["model"],
                                    "count": 2, "dims": [255]}]
    # replicated over "model": the same bits on both ranks
    assert torch.equal(r0["loss"], ranks[1]["loss"])
    for name, axes in r0["split"].items():
        if "model" not in axes:
            assert torch.equal(r0["grads"][name], ranks[1]["grads"][name]), \
                name
    for a, b in zip([r0["prefill"]] + r0["ticks"],
                    [ranks[1]["prefill"]] + ranks[1]["ticks"]):
        assert torch.equal(a, b)
    assert r0["cache_rows"] and set(r0["cache_rows"]) == {cache // 2}
    # the loss and every gradient against the JAX package's
    jloss, jgrads = jax.jit(jax.value_and_grad(functools.partial(
        jtf.train_loss, jcfg)))(params, {k: jnp.asarray(v.astype(np.int32))
                                         for k, v in batch.items()})
    assert abs(float(r0["loss"]) - float(jloss)) <= LOSS_TOL
    for name in r0["grads"]:
        want = jax_full(jgrads, name, cfg)
        got = joined(name, [r["grads"][name] for r in ranks], want.shape)
        assert tuple(got.shape) == want.shape, name
        assert _rel(got, want) <= GRAD_TOL, (arch, name, _rel(got, want))
    # no differing route against one process
    routes = _one_process_routes(cfg, params, batch, monkeypatch)
    assert len(r0["routes"]) == len(routes) == len(ranks[1]["routes"])
    for a, b, c in zip(routes, r0["routes"], ranks[1]["routes"]):
        assert torch.equal(a, b) and torch.equal(b, c)
    # prefill and decode over the split caches
    jpre, jticks = _jax_decode(jcfg, params, batch["tokens"][:, :prompt],
                               ticks, cache)
    np.testing.assert_allclose(r0["prefill"].numpy(), jpre, atol=DECODE_TOL,
                               rtol=DECODE_TOL)
    for got, want in zip(r0["ticks"], jticks):
        np.testing.assert_allclose(got.numpy(), want, atol=DECODE_TOL,
                                   rtol=DECODE_TOL)


def check_data_two_by_model_two_train_step_matches_jax(tmp_path,
                                                       monkeypatch):
    arch = "granite-moe-3b-a800m"
    jcfg, cfg, params, batch = _case(arch)
    job = _job(tmp_path, arch, params, batch, 2, grads=True, steps=1,
               opt={f: getattr(OPT, f) for f in OPT.__dataclass_fields__})
    ranks = spawn(tmp_path, 4, job)
    assert [(r["data_rank"], r["model_rank"]) for r in ranks] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    # the JAX program on the global batch with 2 MoE groups
    monkeypatch.setattr(jmoe, "data_group_count", lambda: 2)
    value_and_grad = jax.jit(jax.value_and_grad(functools.partial(
        jtf.train_loss, jcfg)))
    jbatch = {k: jnp.asarray(v.astype(np.int32)) for k, v in batch.items()}
    jloss, jgrads = value_and_grad(params, jbatch)
    jparams, _, _ = jax.jit(functools.partial(jopt.apply_updates, OPT_J))(
        params, jgrads, jopt.init_opt_state(params))
    assert all(torch.equal(r["loss"], ranks[0]["loss"]) for r in ranks)
    assert abs(float(ranks[0]["loss"]) - float(jloss)) <= LOSS_TOL
    split, dims = ranks[0]["split"], ranks[0]["data_dims"]
    assert dims and all(r["data_dims"] == dims for r in ranks)

    def over_data(key, name, c):
        """Model rank c's tensor: its data ranks' slices joined in rank
        order; where it is whole over "data", the data ranks hold the
        same bits."""
        a, b = ranks[c][key][name], ranks[2 + c][key][name]
        if name in dims:
            return torch.cat([a, b], dim=dims[name])
        assert torch.equal(a, b), (key, name)
        return a

    for name in ranks[0]["grads"]:
        # a data group joins its slices; a model group joins its shards
        grads = [over_data("grads", name, c) for c in (0, 1)]
        params = [over_data("params", name, c) for c in (0, 1)]
        if "model" not in split[name]:
            assert torch.equal(params[0], params[1]), name
        want = jax_full(jgrads, name, cfg)
        got = joined(name, grads, want.shape)
        assert _rel(got, want) <= GRAD_TOL, (name, _rel(got, want))
        wantp = jax_full(jparams, name, cfg)
        gotp = joined(name, params, wantp.shape)
        err = float(np.abs(gotp.numpy() - wantp).max())
        assert err <= PARAM_TOL, (name, err)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "granite-moe-3b-a800m"])
def test_two_model_ranks_match_jax(arch, tmp_path, monkeypatch):
    check_two_model_ranks_match_jax(arch, tmp_path, monkeypatch)


def test_data_two_by_model_two_train_step_matches_jax(tmp_path, monkeypatch):
    check_data_two_by_model_two_train_step_matches_jax(tmp_path, monkeypatch)
