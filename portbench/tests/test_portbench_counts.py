"""The yardstick's counts against hand-worked values, and against the
port's ``cost()`` as it stood when the benchmark was defined (the
values written here, so that a later change to ``cost()`` moves no
yardstick)."""
import json
from pathlib import Path

import pytest

from portbench.counts import kernels, model, peaks

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def load(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_granite_active_weights_by_hand():
    g = load("granite-moe-3b-a800m")
    d, f, E, k, V = 1536, 512, 40, 8, 49155
    attn = d * 24 * 64 + 2 * d * 8 * 64 + 24 * 64 * d        # 6,291,456
    per_layer = attn + d * E + k * 3 * d * f                  # 25,227,264
    assert model.layer_params(g) == per_layer == 25_227_264
    assert model.active_params(g) == 32 * per_layer + V * d == 882_774_528
    # 6 x 0.883 B a token, plus attention's 3 x 4·D·H a kept pair a layer
    pairs = 2 * 4096 * 4097 // 2
    assert model.train_flops(g, 2, 4096) == \
        6 * 882_774_528 * 8192 + 3 * 4 * 64 * 24 * pairs * 32


def test_h2o_weights_and_flops_by_hand():
    h = load("h2o-danube-1.8b")
    d, F = 2560, 6912
    per_layer = 2 * d * 2560 + 2 * d * 640 + 3 * d * F       # 69,468,160
    assert model.layer_params(h) == per_layer == 69_468_160
    assert model.active_params(h) == 24 * per_layer + 32000 * d
    # 4,096-token rows: the window of 4096 keeps every causal pair
    pairs = 4096 * 4097 // 2
    assert kernels.kept_pairs(4096, 4096, 4096) == pairs
    # a 5,000-token row: the window keeps 4096 keys for the last 904
    assert kernels.kept_pairs(5000, 5000, 4096) == pairs + 904 * 4096
    assert model.train_flops(h, 4, 4096) == \
        6 * model.active_params(h) * 4 * 4096 + 3 * 4 * 80 * 32 * 4 * pairs * 24


@pytest.mark.parametrize("args, want", [
    # repro_torch/kernels/flash_attention.py bwd_cost((2, 4096, H, D),
    # (2, 4096, 8, D), bf16[, window=4096]) at this benchmark's definition
    ((2, 4096, 24, 8, 64, None), (257760952320, 135004160)),
    ((2, 4096, 32, 8, 80, 4096), (429601587200, 210763776)),
])
def test_flash_bwd_counts_match_the_ports_cost(args, want):
    assert kernels.flash_bwd(*args) == want


def test_gmm_counts_match_the_ports_cost():
    # moe_gmm.py cost((40, 1638, 1536), 512, bf16) and bwd_cost(...)
    assert kernels.gmm_fwd(40, 40 * 1638, 1536, 512) == \
        (103054049280, 331284480)
    assert kernels.gmm_bwd(40, 40 * 1638, 1536, 512) == \
        (206108098560, 595476480)


def test_least_time_takes_the_slower_bound():
    p = peaks.peaks("NVIDIA H100 80GB HBM3")
    assert peaks.least_time(989e12, 0, p) == pytest.approx(1.0)
    assert peaks.least_time(0, 3.35e12, p) == pytest.approx(1.0)
    assert peaks.least_time(989e9, 3.35e12, p) == pytest.approx(1.0)
    with pytest.raises(KeyError):
        peaks.peaks("cpu")
