"""A batch of 1 served over ("data", "model"): the attention caches'
sequence spread over every rank of the mesh, as the JAX placement
spreads it for ``long_500k``, held to the JAX package's unsharded
functions.

Gloo ranks (``tests/_torch_tp_worker.py``'s ``decode`` job) build their
slice of a smoke model from the JAX package's parameters (unit scores)
and serve one prompt through ``make_prefill_step`` and
``make_decode_step``: the batch of 1 whole on every data rank, each
attention ring of 32 rows split over the d·m ranks, data major (rank
(d, c) holds rows ``(d·m + c)·32/(d·m) …``). Two meshes:

  * gemma3-12b on data 2 x model 2: 4 heads padded to 16 (model rank
    1's heads all dead), the kv heads replicated over "model", window
    layers and a global layer, a tied table; rings of 8 rows a rank;
  * h2o-danube-1.8b (16 heads on 4 kv heads) on data 2 x model 1: the
    rings split over "data" alone, with no model axis in the model; a
    prompt of 60 tokens past its window of 32, rolled into the ring;
    16 rows a rank.

The 8 ticks of each write ring rows 28 .. 31 (the last rank's) and then
0 .. 3 (rank 0's). Checked: the prefill's and every tick's logits
within ``DECODE_TOL`` of the JAX package's ``prefill`` and
``decode_step`` on one device, with the same bits on every rank; each
rank's rows of every ring, after the prefill and after the last tick,
within ``DECODE_TOL`` of the shard of the JAX caches that
``repro/parallel/sharding.cache_shardings`` gives its (data, model)
coordinate. And, in this process: a training batch that does not divide
the data ranks still raises; a served batch of 1 is whole on every rank
while a larger one that does not divide raises
(``parallel/ops.serve_placement``); and a tick refuses caches placed for
another step.
"""
import pickle

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from _torch_tp_worker import spawn  # noqa: E402
from _torch_train_cases import _unit_scores  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402
from repro.configs.base import (  # noqa: E402
    get_smoke_config as jax_smoke_config)
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.parallel import sharding as jsharding  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.parallel import ops as pops  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as steps  # noqa: E402

DECODE_TOL = 2e-5       # float32 attention, tests/test_kernels.py
TICKS = 8
RING = 32
# arch -> (the smoke config's overrides, both packages', data x model,
# the prompt's length)
CASES = {
    "gemma3-12b": ({}, (2, 2), 28),
    "h2o-danube-1.8b": ({"num_heads": 16, "num_kv_heads": 4,
                         "head_dim": 16}, (2, 1), 60),
}


def _jax_serve(jcfg, params, tokens, ticks):
    """The JAX package's prefill logits and caches (padded into rings of
    ``RING`` rows), each decode tick's logits, and the caches after the
    last tick."""
    jlogits, jcaches = jtf.prefill(jcfg, params, jnp.asarray(tokens))

    def ring(a):
        if a.ndim != 5:
            return a
        assert a.shape[2] <= RING, a.shape
        return jnp.pad(a, [(0, 0), (0, 0), (0, RING - a.shape[2]), (0, 0),
                           (0, 0)])
    jcaches = jax.tree_util.tree_map(ring, jcaches)
    first = jax.tree_util.tree_map(np.asarray, jcaches)
    step = jax.jit(lambda p, c, t, q: jtf.decode_step(jcfg, p, c, t, q))
    pos = np.full(1, tokens.shape[1], np.int32)
    out = []
    for t in ticks:
        lg, jcaches = step(params, jcaches, jnp.asarray(t.numpy()),
                           jnp.asarray(pos))
        out.append(np.asarray(lg))
        pos = pos + 1
    return (np.asarray(jlogits), first, out,
            jax.tree_util.tree_map(np.asarray, jcaches))


def _shard(a: np.ndarray, spec, sizes: dict, coords: dict) -> np.ndarray:
    """The block of ``a`` that ``spec`` (a JAX PartitionSpec) gives the
    device at ``coords``: each split dim cut into its axes' product of
    blocks, the first axis of an entry the slowest."""
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        k, i = 1, 0
        for ax in axes:
            k, i = k * sizes[ax], i * sizes[ax] + coords[ax]
        n = a.shape[dim] // k
        a = np.take(a, range(i * n, (i + 1) * n), axis=dim)
    return a


def _check_rings(got: list, want, specs, cfg, sizes, coords, what):
    """A rank's rings (one entry a layer, None for a recurrent layer)
    against its shard of the JAX caches (a tuple over pattern positions,
    each leaf stacked over periods)."""
    for i, ring in enumerate(got):
        if ring is None:
            continue
        p, j = divmod(i, len(cfg.pattern))
        for name in ("k", "v"):
            shard = _shard(want[j][name], specs[j][name].spec, sizes,
                           coords)[p]
            assert ring[name].shape == shard.shape, (what, i, name)
            np.testing.assert_allclose(ring[name].numpy(), shard,
                                       atol=DECODE_TOL, rtol=DECODE_TOL,
                                       err_msg=f"{what} layer {i} {name}")


@pytest.mark.parametrize("arch", list(CASES))
def test_batch_of_one_over_data_and_model_matches_jax(arch, tmp_path):
    scaled, (d, m), prompt = CASES[arch]
    jcfg = jax_smoke_config(arch).scaled(**scaled)
    cfg = get_smoke_config(arch).scaled(**scaled)
    params = _unit_scores(jlayers.split_annotated(
        jtf.init_model(jcfg, jax.random.PRNGKey(0)))[0], cfg)
    rng = np.random.default_rng(len(arch))
    tokens = rng.integers(0, cfg.vocab_size, (1, prompt))
    ticks = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, 1)))
             for _ in range(TICKS)]
    with open(tmp_path / "params.pkl", "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, params), f)
    torch.save({"tokens": torch.from_numpy(tokens)}, tmp_path / "batch.pt")
    torch.save(ticks, tmp_path / "ticks.pt")
    job = {"init": f"file://{tmp_path}/store", "arch": arch,
           "scaled": scaled, "model": m,
           "params": str(tmp_path / "params.pkl"),
           "batch": str(tmp_path / "batch.pt"),
           "out": str(tmp_path / "out_{rank}.pt"), "decode": True,
           "prompt": prompt, "cache_len": RING,
           "ticks": str(tmp_path / "ticks.pt")}
    ranks = spawn(tmp_path, d * m, job)
    assert [(r["data_rank"], r["model_rank"]) for r in ranks] == \
        [(a, b) for a in range(d) for b in range(m)]
    # every rank holds 32 / (d·m) rows of each ring, and the same logits
    r0 = ranks[0]
    assert r0["cache_rows"] and set(r0["cache_rows"]) == {RING // (d * m)}
    for r in ranks[1:]:
        for a, b in zip([r0["prefill"]] + r0["ticks"],
                        [r["prefill"]] + r["ticks"]):
            assert torch.equal(a, b)
    jpre, jfirst, jticks, jlast = _jax_serve(jcfg, params, tokens, ticks)
    np.testing.assert_allclose(r0["prefill"].numpy(), jpre, atol=DECODE_TOL,
                               rtol=DECODE_TOL)
    for got, want in zip(r0["ticks"], jticks):
        np.testing.assert_allclose(got.numpy(), want, atol=DECODE_TOL,
                                   rtol=DECODE_TOL)
    # each rank's rows: the JAX placement's shard at its coordinate
    mesh = AbstractMesh((d, m), ("data", "model"))
    specs = jsharding.cache_shardings(jcfg, jax.eval_shape(
        lambda: jtf.init_caches(jcfg, 1, RING)), mesh, 1)
    assert all(s["k"].spec[2] == ("data", "model") for s in specs
               if isinstance(s, dict) and "k" in s)
    sizes = {"data": d, "model": m}
    for r in ranks:
        coords = {"data": r["data_rank"], "model": r["model_rank"]}
        _check_rings(r["caches"], jfirst, specs, cfg, sizes, coords,
                     f"prefill {coords}")
        _check_rings(r["final_caches"], jlast, specs, cfg, sizes, coords,
                     f"after the ticks {coords}")


def _two_rank_view() -> Mesh:
    """Rank 0's mesh of a data axis of 2 processes, without the group
    (the batch is cut, or refused, before any collective)."""
    cpu = torch.device("cpu")
    return Mesh((cpu, cpu), ("data", "model"), {"data": 2, "model": 1},
                group=object(), rank=0)


def test_training_batch_that_does_not_divide_still_raises():
    cfg = get_smoke_config("h2o-danube-1.8b").scaled(num_layers=1)
    model = tf.init_model(cfg, device="cpu", trainable=True)
    step = steps.make_train_step(cfg, opt.AdamWConfig(), _two_rank_view())
    state = opt.init_opt_state(dict(model.named_parameters()))
    for rows in (1, 3):
        batch = {k: np.zeros((rows, 8), np.int64)
                 for k in ("tokens", "labels")}
        with pytest.raises(ValueError, match="does not divide"):
            step(model, state, batch)


def test_served_batch_of_one_is_whole_on_every_data_rank():
    mesh = _two_rank_view()
    one = {"tokens": np.zeros((1, 1)), "pos": np.zeros(1)}
    assert pops.serve_placement(mesh, 1) == (1, (2, 0))
    assert steps.serve_rows(mesh, one)["tokens"].shape == (1, 1)
    assert pops.serve_placement(mesh, 4) == (2, (1, 0))
    four = steps.serve_rows(mesh, {k: np.zeros((4,) + v.shape[1:])
                                   for k, v in one.items()})
    assert four["tokens"].shape == (2, 1)
    with pytest.raises(ValueError, match="does not divide"):
        steps.serve_rows(mesh, {k: np.zeros((3,) + v.shape[1:])
                                for k, v in one.items()})
    # one process, and no mesh: the whole batch
    assert pops.serve_placement(None, 3) == (3, (1, 0))
    solo = Mesh((torch.device("cpu"),), ("data", "model"),
                {"data": 1, "model": 1})
    assert pops.serve_placement(solo, 3) == (3, (1, 0))


def test_a_tick_on_caches_of_another_placement_raises():
    """gemma3-12b's smoke period on a dry run's view of data 2 x model 2
    (meta tensors): caches made for a global batch of 1 (each ring split
    over the 4 ranks) are refused by a tick run with no served batch
    installed, and by a step serving 2 rows (one a data rank, the rings
    then split over "model" alone): nothing is decoded from rows placed
    for another step."""
    cfg = get_smoke_config("gemma3-12b")
    view = Mesh((), ("data", "model"), {"data": 2, "model": 2})
    model = tf.init_model(cfg, device="meta", mesh=view)
    caches = tf.init_caches(cfg, 1, 4 * RING, "meta", mesh=view)
    assert [c["k"].shape[1] for c in caches] == [RING // 4] * 5 + [RING]
    tokens = torch.zeros((1, 1), dtype=torch.long, device="meta")
    pos = torch.zeros(1, dtype=torch.int32, device="meta")
    with pops.use_mesh(view, sharding.default_rules(view)):
        with pytest.raises(ValueError, match="served batch .* not known"):
            tf.decode_step(model, caches, tokens, pos)
    step = steps.make_decode_step(cfg, view)
    two = {"tokens": torch.zeros((2, 1), dtype=torch.long, device="meta"),
           "pos": torch.zeros(2, dtype=torch.int32, device="meta")}
    with pytest.raises(ValueError, match="not a rank's part"):
        step(model, caches, two)
    # the step they were made for takes them
    logits, _ = steps.make_decode_step(cfg, view)(
        model, caches, {"tokens": tokens, "pos": pos})
    assert logits.shape == (1, 1, cfg.vocab_size)
