"""The dry run's ``long_500k`` cells: a batch of 1 whose attention caches'
sequence is spread over ("data", "model"), as the JAX placement spreads
it (``launch/dryrun.py``, ``parallel/ops.serve_placement``).

  * gemma3-12b and h2o-danube-1.8b on ``node`` and ``pod``: one device's
    ``cache_bytes`` equal to the JAX placement's (gemma3-12b's 4.34 GB
    on ``node``, 0.1355 GB on ``pod``), and ``jax_differences`` names
    no cause for the caches;
  * jamba-v0.1-52b on ``pod``: the one cause for the caches is Mamba's
    conv state, which the port splits by d_inner;
  * the ``meta`` count of a batch-1 tick holds the merge's gather over
    "data": one more all-gather an attention layer than the same tick
    with its rings split over "model" alone, of d·m times a (B, H,
    D + 1) float32 part.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as cfgbase  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_dryrun_mesh  # noqa: E402

GEMMA_CACHE = {"node": 4_336_910_336, "pod": 135_528_448}   # bf16 bytes


@pytest.mark.parametrize("mesh", ["node", "pod"])
@pytest.mark.parametrize("arch", ["gemma3-12b", "h2o-danube-1.8b"])
def test_long_context_caches_are_the_jax_placements(arch, mesh):
    r = dryrun.run_cell(arch, "long_500k", mesh)
    assert r["batch_per_device"] == 1
    assert r["memory"]["cache_bytes"] == r["jax_memory"]["cache_bytes"]
    assert r["jax_differences"]["cache"] == []
    if arch == "gemma3-12b":
        assert r["memory"]["cache_bytes"] == GEMMA_CACHE[mesh]


def test_jamba_long_context_differs_by_the_conv_state_only():
    r = dryrun.run_cell("jamba-v0.1-52b", "long_500k", "pod")
    causes = r["jax_differences"]["cache"]
    assert len(causes) == 1 and causes[0].startswith("Mamba's conv state")
    cfg = cfgbase.get_config("jamba-v0.1-52b")
    # the JAX placement holds the conv state whole over "model": 15/16 of
    # it more than the port's slice of a (B, d_conv - 1, d_inner) state
    # in bf16 a Mamba layer
    conv = (cfg.mamba_d_conv - 1) * cfg.d_model * cfg.mamba_expand * 2
    mamba = sum(spec.mixer == "mamba" for spec in cfg.pattern) * \
        cfg.num_periods
    assert r["jax_memory"]["cache_bytes"] - r["memory"]["cache_bytes"] == \
        mamba * conv * 15 // 16


@pytest.mark.parametrize("mesh", ["node", "pod"])
def test_batch_of_one_tick_counts_the_merge_over_data(mesh):
    """The same tick of one device (one row, gemma3-12b's 6-layer period)
    counted with a global batch of 1 and of one row a data rank: the
    first splits every ring over ("data", "model") and adds to each
    attention layer's merge one gather of the model ranks' stacked
    (1, 16, 257) float32 parts over the data axis."""
    cfg = cfgbase.get_config("gemma3-12b").scaled(num_layers=6)
    cell = cfgbase.SHAPES["long_500k"]
    view = dryrun.device_view(make_dryrun_mesh(mesh))
    d, m = view.shape["data"], view.shape["model"]
    one, out, _ = dryrun.count_step(cfg, cell, 1, "meta", view)
    many, _, _ = dryrun.count_step(cfg, cell, view.processes, "meta", view)
    rows = [c["k"].shape[1] for c in out[1]]
    assert rows == [1024 // (d * m)] * 5 + [524_288 // (d * m)]
    part = cfg.num_heads * (cfg.resolved_head_dim + 1) * 4
    a, b = one.collectives["all-gather"], many.collectives["all-gather"]
    assert a["count"] - b["count"] == 6
    assert a["bytes"] - b["bytes"] == 6 * d * m * part
