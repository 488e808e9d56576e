"""The plain references against the port's CPU path, at a small size:
the same weights and inputs, float32 on both sides."""
import pytest
import torch

from portbench import harness, port, traffic
from portbench import weights as W
from portbench.drivers import train as TD
from portbench.reference import moe as RM
from portbench.reference import transformer as ref

from .conftest import TRAIN_SMALL, small


def config(name, **extra):
    man = harness.manifest()
    return {**harness.config(man, name), **small(name, **extra)}


@pytest.mark.parametrize("name", ["h2o-danube-1.8b", "granite-moe-3b-a800m"])
def test_training_loss_gradients_and_adamw_match(name):
    cfg = config(name, train={"param_dtype": "float32",
                              "compute_dtype": "float32", "remat": True})
    tr = {**harness.traffic("train_2x4096"), **TRAIN_SMALL}
    run = harness.Run("x", cfg, tr, 2 ** 32 + 9, 0.0, False,
                      torch.device("cpu"), 0.0, spans=harness.T.Spans(False))
    state = TD.setup(run)
    want = ref.train_readings(cfg, run.seed, "cpu",
                              traffic.train_pool(cfg, tr, run.seed)[:3])
    got = TD.train_numbers(state.first, want)
    assert got["loss_gap"] < 1e-6, got
    assert got["grad1_gap"] < 1e-5, got
    assert got["change_gap"] < 1e-5, got


def test_moe_drops_past_capacity_as_the_port_does():
    from repro_torch.models import moe
    cfg = config("granite-moe-3b-a800m", capacity_factor=0.5)
    w = W.draw_layer(cfg, 5, 0, "cpu")
    h = torch.randn(2, 40, cfg["hidden_size"], generator=torch.Generator().manual_seed(1))
    y, lb, z = RM.forward(cfg, w, h, "float32")
    params = {"router": w["ffn.router"], "wg": w["ffn.wg"], "wu": w["ffn.wu"],
              "wo": w["ffn.wo"]}
    y2, (lb2, z2) = moe.moe_forward(h, params, n_experts=8, top_k=2,
                                    capacity_factor=0.5)
    _, _, _, gate_i = RM.route(h.reshape(80, -1), w["ffn.router"], 2, "float32")
    dropped = ~RM.kept(gate_i, 8, RM.capacity(80, 2, 8, 0.5))
    assert dropped.sum() > 0
    assert torch.allclose(y, y2, atol=1e-5)
    assert torch.allclose(lb, lb2) and torch.allclose(z, z2)


def test_the_fp8_control_rounds_every_product():
    a = torch.randn(64, 64, generator=torch.Generator().manual_seed(0))
    err = (ref.mm(a, a, "fp8") - a @ a).abs().max() / (a @ a).abs().max()
    assert 1e-3 < err < 0.1
    assert torch.equal(ref.mm(a, a, "float32"), a @ a)
