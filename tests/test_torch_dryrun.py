"""The port's dry run against the JAX package's, on the CPU.

For every arch: ``param_specs`` gives the leaves (paths, shapes, types,
logical axes) of the JAX ``split_annotated(init_model(...))`` under
``shape_only()``; ``total_params``, ``active_params`` and the model FLOPs
of every cell are the JAX dry run's; the meta inputs of every cell have
the JAX ``specs.py``'s shapes and types (decode caches: ``jax.eval_shape``
of the JAX ``init_caches``); ``param_shardings`` and ``cache_shardings``
give the JAX specs and fallbacks on ``AbstractMesh`` 16x16 and 2x16x16.
The op count (``launch/op_analysis.py``) is exact on hand-computed cases
(``mm``, ``bmm``, a reduction, a rematerialised block counted twice);
each kernel's ``cost`` is its closed form (the Bound column's formulas);
a 2-layer narrow step counts the same twice on ``meta``, and a prefill
and a decode tick count on the CPU what they count on ``meta``. All
counts are integers and compared exactly.
"""
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.launch import specs as jspecs  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.parallel import sharding as jshd  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.kernels import conv_scorer as cs  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.kernels import scorer_head as sh  # noqa: E402
from repro_torch.launch import dryrun, op_analysis  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.parallel import sharding as tshd  # noqa: E402

# the JAX dry run forces 512 host devices through XLA_FLAGS when it is
# imported; this process keeps its own setting
_SAVED = {k: os.environ.get(k) for k in ("XLA_FLAGS",)}
from repro.launch import dryrun as jdry  # noqa: E402
for _k, _v in _SAVED.items():
    if _v is None:
        os.environ.pop(_k, None)
    else:
        os.environ[_k] = _v

ARCHS = jbase.ARCH_IDS
MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}


def _amesh(name):
    sizes, names = MESHES[name]
    try:
        return AbstractMesh(sizes, names)
    except TypeError:
        return AbstractMesh(tuple(zip(names, sizes)))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tree(arch):
    with jlayers.shape_only():
        ann = jtf.init_model(jbase.get_config(arch), jax.random.PRNGKey(0))
    return jlayers.split_annotated(ann)


def _jpath(path):
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def _is_axes(x):
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def _flat(tree):
    """Leaves of a port tree in jax.tree_util's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _flat(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


def _leaf_specs(tree, specs):
    """The specs at a cache tree's leaves, in ``_flat``'s order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaf_specs(tree[k],
                                                             specs[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t, sp in zip(tree, specs) for x in _leaf_specs(t, sp)]
    return [specs]


def _shape_dtype(t):
    return tuple(t.shape), str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_counts_match_the_jax_tree(arch):
    params, axes = _jax_tree(arch)
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    jaxes = jax.tree_util.tree_leaves(axes, is_leaf=_is_axes)
    want = [(_jpath(p), tuple(x.shape), x.dtype.name, a)
            for (p, x), a in zip(flat, jaxes)]
    specs = ttf.param_specs(tbase.get_config(arch))
    got = [(s.path, s.shape, str(s.dtype)[6:], s.axes) for s in specs]
    assert got == want
    cfg, jcfg = tbase.get_config(arch), jbase.get_config(arch)
    assert dryrun.count_params(specs) == jdry.count_params(params)
    assert dryrun.active_params(cfg) == jdry.active_params(jcfg)
    for cell in tbase.cells_for(arch):
        assert dryrun.model_flops(cfg, cell) == \
            jdry.model_flops(jcfg, jbase.SHAPES[cell.name])


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_inputs_match_the_jax_specs(arch):
    cfg = tbase.get_config(arch)
    for cell in tbase.cells_for(arch):
        want = jspecs.input_specs(arch, cell.name)
        got = tspecs.input_specs(arch, cell.name)
        if cell.kind == "decode":
            (want, wcache), (got, gcache) = want, got
            assert all(t.device.type == "meta" for t in _flat(gcache))
            gcache = tspecs.stacked_caches(cfg, gcache)
            assert [_shape_dtype(t) for t in _flat(gcache)] == \
                [(tuple(x.shape), x.dtype.name)
                 for x in jax.tree_util.tree_leaves(wcache)]
        assert sorted(got) == sorted(want)
        for k in want:
            assert _shape_dtype(got[k]) == (tuple(want[k].shape),
                                            want[k].dtype.name), k
            assert got[k].device.type == "meta"


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_cache_shardings_match(arch, mesh):
    am = _amesh(mesh)
    params, axes = _jax_tree(arch)
    jfb, tfb = [], []
    want = [tuple(s.spec) for s in jax.tree_util.tree_leaves(
        jshd.param_shardings(params, axes, am, collect_fallbacks=jfb))]
    got = tshd.param_shardings(ttf.param_specs(tbase.get_config(arch)), am,
                               collect_fallbacks=tfb)
    assert got == want
    assert tshd.explain_fallbacks(tfb) == jshd.explain_fallbacks(jfb)
    # the production mesh the dry run uses places them alike
    assert tshd.param_shardings(
        ttf.param_specs(tbase.get_config(arch)),
        make_production_mesh(multi_pod=mesh == "multipod")) == want
    cfg, jcfg = tbase.get_config(arch), jbase.get_config(arch)
    for cell in tbase.cells_for(arch):
        if cell.kind != "decode":
            continue
        B = cell.global_batch
        jc = jax.eval_shape(lambda: jtf.init_caches(jcfg, B, cell.seq_len))
        want = [tuple(s.spec) for s in jax.tree_util.tree_leaves(
            jshd.cache_shardings(jcfg, jc, am, B))]
        tc = tspecs.stacked_caches(cfg, ttf.init_caches(cfg, B, cell.seq_len,
                                                        "meta"))
        got = _leaf_specs(tc, tshd.cache_shardings(cfg, tc, am, B))
        assert got == want, (arch, cell.name)


# -- the op count -------------------------------------------------------------

def test_counter_is_exact_on_hand_computed_cases():
    a = torch.empty(3, 5, device="meta")
    b = torch.empty(5, 7, device="meta")
    with op_analysis.count("meta") as c:
        torch.mm(a, b)
    assert (c.flops, c.bytes) == (2 * 3 * 5 * 7, 4 * (15 + 35 + 21))
    x = torch.empty(2, 3, 4, device="meta", dtype=torch.bfloat16)
    y = torch.empty(2, 4, 6, device="meta", dtype=torch.bfloat16)
    with op_analysis.count("meta") as c:
        torch.bmm(x, y)
    assert (c.flops, c.bytes) == (2 * 2 * 3 * 4 * 6, 2 * (24 + 48 + 36))
    assert dict(c.flops_by_class) == {"bfloat16": 288}
    with op_analysis.count("meta") as c:
        a.sum(dim=-1)                       # 1 a value read
    assert (c.flops, c.bytes) == (15, 4 * (15 + 3))
    with op_analysis.count("meta") as c:
        a.add_(1.0)                         # in place: one storage, once
        a[:, :2].mul(2.0)                   # a view: the elements it spans
        a.t().contiguous()                  # a copy moves, computes nothing
    assert c.op_flops == {"add_": 15, "mul": 6, "clone": 0}
    assert c.op_bytes == {"add_": 60, "mul": 6 * 4 + 6 * 4, "clone": 120}
    # an indexed read moves its rows, not the table
    table = torch.empty(1000, 8, device="meta")
    idx = torch.zeros(4, dtype=torch.long, device="meta")
    with op_analysis.count("meta") as c:
        table[idx]
    assert c.bytes == 8 * 4 + 4 * 8 * 4 + 4 * 8 * 4   # ids, out, rows read


def test_remat_block_is_counted_twice():
    from torch.utils.checkpoint import checkpoint
    w = torch.empty(8, 8, device="meta", requires_grad=True)
    x = torch.empty(4, 8, device="meta", requires_grad=True)

    def block(x):
        return torch.tanh(x @ w)

    counts = {}
    for remat in (False, True):
        with op_analysis.count("meta") as c:
            y = checkpoint(block, x, use_reentrant=False) if remat else \
                block(x)
            y.sum().backward()
        counts[remat] = c
    plain, remat = counts[False], counts[True]
    assert remat.op_calls["tanh"] == plain.op_calls["tanh"] + 1
    assert remat.op_calls["mm"] == plain.op_calls["mm"] + 1
    # the forward once more in the backward: its product and its tanh
    assert remat.op_flops["mm"] == plain.op_flops["mm"] + 2 * 4 * 8 * 8
    assert remat.op_flops["tanh"] == plain.op_flops["tanh"] + 4 * 8


def test_kernel_costs_match_their_closed_forms():
    """The Bound column's formulas (``chip_smoke.py`` before the costs
    moved into the kernel modules), at the table's shapes and others."""
    def pairs(sq, sk, window):
        pos = np.arange(sq, dtype=np.int64)
        lo = np.maximum(0, pos - window + 1) if window else np.zeros_like(pos)
        return int(np.sum(np.minimum(pos, sk - 1) - lo + 1))

    for R, d, dt in ((2048, 2560, torch.bfloat16), (4096, 1536, torch.float32),
                     (8, 6144, torch.bfloat16)):
        size = dt.itemsize
        assert rms.cost((R, d), dt) == (3 * R * d, 2 * R * d * size + 4 * d)
        assert rms.bwd_cost((R, d), dt) == (10 * R * d,
                                            3 * R * d * size + 8 * d)
    for B, S, H, KV, D, W, dt in ((1, 2048, 32, 8, 80, 4096, torch.bfloat16),
                                  (4, 1024, 24, 8, 64, None, torch.bfloat16),
                                  (1, 4096, 32, 8, 80, 4096, torch.float32),
                                  (1, 257, 16, 8, 256, 512, torch.bfloat16)):
        q, k, size = (B, S, H, D), (B, S, KV, D), dt.itemsize
        p = B * pairs(S, S, W)
        assert fa.cost(q, k, dt, window=W) == (
            4 * D * H * p, (2 * B * S * H * D + 2 * B * S * KV * D) * size)
        assert fa.bwd_cost(q, k, dt, window=W) == (
            10 * D * H * p,
            (4 * B * S * H * D + 4 * B * S * KV * D) * size + 4 * B * H * S)
    assert fa.kept_pairs(6, 6, None) == 21 and fa.kept_pairs(6, 6, 2) == 11
    n_valid = [3, 4096, 17, 4096, 1, 2000, 999, 4096]
    for dt in (torch.bfloat16, torch.float32):
        B, H, KV, D, S, size = 8, 32, 8, 80, 4096, dt.itemsize
        nv = sum(n_valid)
        assert da.cost((B, H, D), (B, S, KV, D), dt, n_valid=nv) == (
            4 * D * H * nv, (2 * nv * KV * D + 2 * B * H * D) * size + 4 * B)
        assert da.cost((B, H, D), (B, S, KV, D), dt)[0] == 4 * D * H * B * S
    for E, C, d, f, dt in ((40, 512, 1536, 512, torch.bfloat16),
                           (16, 320, 4096, 14336, torch.bfloat16),
                           (40, 1024, 512, 1536, torch.float32)):
        size = dt.itemsize
        assert gmm.cost((E, C, d), f, dt) == (
            2 * E * C * d * f, (E * C * d + E * d * f + E * C * f) * size)
        assert gmm.bwd_cost((E, C, d), f, dt) == (
            4 * E * C * d * f,
            (2 * E * C * d + 2 * E * d * f + E * C * f) * size)
    for h, cin, cout in ((100, 3, 32), (50, 32, 32), (13, 32, 32), (7, 8, 8)):
        taps = sum(0 <= o * 2 - ref.same_pad(h, 2)[1] + t < h
                   for o in range(ref.same_pad(h, 2)[0]) for t in range(3))
        ho = -(-h // 2)
        one = (2 * cin * cout * 1024 * taps ** 2,
               4 * (1024 * h * h * cin + 9 * cin * cout + cout +
                    1024 * ho * ho * cout))
        assert cs.cost((1024, h, h, cin), cout) == one
        assert cs.cost((8, 1024, h, h, cin), cout) == (8 * one[0],
                                                       8 * one[1])
    assert sh.cost(1024, 512, 64) == (2 * 1024 * 64 * 514, 4 * (
        1024 * 512 + 512 * 64 + 64 + 128 + 2 + 2048))
    assert sh.cost(1024, 512, 64, 8) == tuple(8 * v for v in
                                              sh.cost(1024, 512, 64))


def test_kernels_report_their_cost_on_every_device():
    """A wrapper reports its kernel's cost on the CPU (its plain version
    runs, uncounted) as on ``meta`` (an empty result)."""
    counts = {}
    for dev in ("cpu", "meta"):
        x = torch.zeros(4, 64, device=dev)
        w = torch.ones(64, device=dev)
        q = torch.zeros(1, 16, 4, 16, device=dev)
        kv = torch.zeros(1, 16, 2, 16, device=dev)
        xe = torch.zeros(2, 8, 16, device=dev)
        we = torch.zeros(2, 16, 8, device=dev)
        pos = torch.full((1,), 15, dtype=torch.int32, device=dev)
        with op_analysis.count(dev) as c:
            y = rms.rmsnorm(x, w)
            o = fa.flash_attention(q, kv, kv, window=4)
            d = da.decode_attention(q[:, 0], kv, kv, pos)
            g = gmm.moe_gmm(xe, we)
        assert (y.shape, o.shape, d.shape, g.shape) == (
            (4, 64), (1, 16, 4, 16), (1, 4, 16), (2, 8, 8))
        assert not c.op_calls            # the wrappers' bodies uncounted
        counts[dev] = c.summary()
    assert counts["cpu"] == counts["meta"]
    k = counts["meta"]["kernels"]
    assert k["rmsnorm"] == {"calls": 1, "flops": 3 * 256,
                            "bytes": 2 * 256 * 4 + 4 * 64}
    assert k["flash_attention"]["flops"] == 4 * 16 * 4 * fa.kept_pairs(
        16, 16, 4)
    assert k["moe_gmm"]["flops"] == 2 * 2 * 8 * 16 * 8


def test_wrappers_do_no_count_work_outside_a_count(monkeypatch):
    """With no counter active a wrapper computes no cost (the decode
    tick is host-bound); inside a count it does."""
    def refuse(*args, **kwargs):
        raise AssertionError("cost computed")
    for mod in (rms, fa, da, gmm):
        monkeypatch.setattr(mod, "cost", refuse)
    x, w = torch.zeros(4, 64), torch.ones(64)
    q, kv = torch.zeros(1, 16, 4, 16), torch.zeros(1, 16, 2, 16)
    pos = torch.full((1,), 15, dtype=torch.int32)
    rms.rmsnorm(x, w)
    fa.flash_attention(q, kv, kv)
    da.decode_attention(q[:, 0], kv, kv, pos)
    gmm.moe_gmm(torch.zeros(2, 8, 16), torch.zeros(2, 16, 8))
    with op_analysis.count("cpu"), pytest.raises(AssertionError,
                                                 match="cost computed"):
        rms.rmsnorm(x, w)


def test_meta_results_keep_the_cards_strides():
    """The card's ``empty_like`` keeps a contiguous input's strides, size-1
    dims included, and so must a wrapper's ``meta`` result: a prefill's
    last position (a (1, 1, d) slice) normed on the card keeps the
    sequence's stride, and its logits' ``matmul`` is a ``bmm``, not an
    ``mm`` (``meta``'s own ``empty_like`` gave (d, d, 1), and the dry
    run counted an ``mm``)."""
    x = torch.empty(1, 7, 64, device="meta")[:, -1:]
    y = rms.rmsnorm(x, torch.ones(64, device="meta"))
    assert y.stride() == x.stride() == (7 * 64, 64, 1)
    table = torch.empty(100, 64, device="meta")
    with op_analysis.count("meta") as c:
        y @ table.T
    assert dict(c.op_calls) == {"bmm": 1}


# PERF.md's Bound ms column (chip_smoke.py's rows), which the costs keep
BOUND_ROWS = {"conv chunk": 0.2989, "conv grouped": 2.3916,
              "rmsnorm": 0.0063, "flash": 0.0217, "decode": 0.0116,
              "moe_gmm": 0.0438, "moe_gmm jamba": 0.6173,
              "scorer_head": 0.0010, "scorer_head grouped": 0.0080,
              "rmsnorm_bwd bf16": 0.0113, "rmsnorm_bwd f32": 0.0225,
              "flash_bwd": 0.0326, "flash_bwd h2o": 0.2172,
              "moe_gmm_bwd": 0.1303, "moe_gmm_bwd up": 0.1303}


def test_bound_column_is_unchanged():
    """``chip_smoke.py``'s Bound ms, now from the kernels' ``cost``, at
    every row of PERF.md's kernel table, to its 4 decimals."""
    import chip_smoke as smoke
    bf, f32 = torch.bfloat16, torch.float32

    def ms(cost, dt):
        return round(smoke._bound(*cost, dt)[0], 4)

    chunk = [cs.cost((1024, h, h, cin), cout)
             for h, cin, cout in smoke.layers(smoke.MAIN_OP)]
    t = max(sum(c[0] for c in chunk) / smoke.PEAK_FP32_FLOPS,
            sum(c[1] for c in chunk) / smoke.PEAK_BYTES_PER_S) * 1e3
    pos = np.random.default_rng(0).integers(0, 4096, size=8)
    pos[-1] = 4096 + 904
    got = {
        "conv chunk": round(t, 4), "conv grouped": ms(
            tuple(map(sum, zip(*[cs.cost((8, 1024, h, h, cin), cout)
                                 for h, cin, cout in smoke.layers(
                                     smoke.MAIN_OP)]))), f32),
        "rmsnorm": ms(rms.cost((2048, 2560), bf), bf),
        "flash": ms(fa.cost((1, 2048, 32, 80), (1, 2048, 8, 80), bf,
                            window=4096), bf),
        "decode": ms(da.cost((8, 32, 80), (8, 4096, 8, 80), bf, n_valid=int(
            np.minimum(pos + 1, 4096).sum())), bf),
        "moe_gmm": ms(gmm.cost((40, 512, 1536), 512, bf), bf),
        "moe_gmm jamba": ms(gmm.cost((16, 320, 4096), 14336, bf), bf),
        "scorer_head": ms(sh.cost(1024, 512, 64), f32),
        "scorer_head grouped": ms(sh.cost(1024, 512, 64, 8), f32),
        "rmsnorm_bwd bf16": ms(rms.bwd_cost((4096, 1536), bf), bf),
        "rmsnorm_bwd f32": ms(rms.bwd_cost((4096, 1536), f32), f32),
        "flash_bwd": ms(fa.bwd_cost((4, 1024, 24, 64), (4, 1024, 8, 64), bf),
                        bf),
        "flash_bwd h2o": ms(fa.bwd_cost((1, 4096, 32, 80), (1, 4096, 8, 80),
                                        bf, window=4096), bf),
        "moe_gmm_bwd": ms(gmm.bwd_cost((40, 1024, 1536), 512, bf), bf),
        "moe_gmm_bwd up": ms(gmm.bwd_cost((40, 1024, 512), 1536, bf), bf)}
    assert got == BOUND_ROWS


# -- whole steps ----------------------------------------------------------------

CUT = {"prefill_32k": 32, "decode_32k": 32, "train_4k": 32}


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "jamba-v0.1-52b",
                                  "llava-next-34b"])
def test_narrow_step_counts_the_same_twice_and_on_the_cpu(arch):
    cfg = tbase.get_smoke_config(arch)
    cfg = cfg.scaled(num_layers=2 * len(cfg.pattern)) \
        if cfg.num_layers > 2 * len(cfg.pattern) else cfg
    for shape, seq in CUT.items():
        cell = tbase.ShapeCell(shape, tbase.SHAPES[shape].kind, seq, 2)
        a = dryrun.count_step(cfg, cell, 2, "meta")[0].summary()
        b = dryrun.count_step(cfg, cell, 2, "meta")[0].summary()
        assert a == b and a["flops"] > 0 and a["bytes"] > 0
        assert all(isinstance(v, int) for v in (a["flops"], a["bytes"]))
        if cell.kind != "train":
            # the optimizer's host scalars are the CPU step's device work
            assert dryrun.count_step(cfg, cell, 2, "cpu")[0].summary() == a
    kinds = set(a["kernels"])
    assert {"rmsnorm", "rmsnorm_bwd"} <= kinds
    if "moe" in {s.ffn for s in cfg.pattern}:
        assert {"moe_gmm", "moe_gmm_bwd"} <= kinds


def test_prefill_of_several_rows_takes_the_kernels_on_meta():
    """The dry run checks shapes as the card does: a prefill of B > 1
    rows normed its last positions as a strided (B, 1, d) slice, which
    the norm's kernel refuses (it takes contiguous rows)."""
    cfg = tbase.get_smoke_config("h2o-danube-1.8b")
    model = ttf.init_model(cfg, device="meta")
    logits, caches = ttf.prefill(model, torch.zeros(3, 8, dtype=torch.long,
                                                    device="meta"))
    assert logits.shape == (3, 1, cfg.vocab_size)


def test_meta_model_holds_nothing():
    cfg = tbase.get_config("llama4-maverick-400b-a17b")
    model = ttf.init_model(cfg, device="meta", trainable=True)
    n = sum(p.numel() for p in model.parameters())
    assert n > 3e11 and all(p.device.type == "meta"
                            for p in model.parameters())
    caches = ttf.init_caches(cfg, 128, 32768, "meta")
    assert all(t.device.type == "meta" for t in _flat(caches))


def test_cli_writes_every_mesh_of_a_cell(tmp_path):
    import json
    rc = dryrun.main(["--arch", "h2o-danube-1.8b", "--shape", "decode_32k",
                      "--mesh", "all", "--out", str(tmp_path)])
    assert rc == 0
    out = {p.stem.split("__")[-1]: json.loads(p.read_text())
           for p in tmp_path.glob("*.json")}
    assert sorted(out) == ["card", "multipod", "node", "pod"]
    for mesh, r in out.items():
        assert r["error"] is None and r["n_devices"] == {
            "card": 1, "node": 8, "pod": 256, "multipod": 512}[mesh]
        assert r["executed"] is (mesh in ("card", "node"))
    card, node = out["card"], out["node"]
    assert card["batch_per_device"] == 128 and node["batch_per_device"] == 16
    assert card["per_device"]["flops"] > 0 and out["pod"]["per_device"] is None
    assert card["roofline"]["model_flops_global"] == \
        out["pod"]["roofline"]["model_flops_global"]
    assert math.isclose(card["roofline"]["memory_s"],
                        card["per_device"]["bytes"] / dryrun.PEAK_BYTES_PER_S)
    assert set(card["per_device"]["kernels"]) == {"rmsnorm",
                                                   "decode_attention"}
