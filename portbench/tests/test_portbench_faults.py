"""A run with its look for a card skipped, driven on the CPU at a small
size, comes out correct, and comes out not correct with the timed path
broken underneath: once for each fault a training cell can have (one
chip, so no exchange between chips to leave out; no token is served)."""
import time

import pytest

from portbench import harness

from .conftest import TRAIN_SMALL, small

TRAIN = [w["name"] for w in harness.manifest()["workloads"]]


def run(cell, seed=2 ** 31 + 77):
    cfg = cell.rsplit(".", 1)[0]
    over = {"config": small(cfg), "traffic": TRAIN_SMALL}
    return harness.execute(cell, seed, 0.5, False, "cpu",
                           time.perf_counter(), over)


@pytest.mark.parametrize("cell", TRAIN)
def test_a_sound_run_is_correct(cell):
    res = run(cell)
    assert res["correct"], res["checks"]
    assert list(res)[-1] == "checks"
    assert {"setup_s"} < set(res["metrics"])


@pytest.mark.parametrize("cell", TRAIN)
def test_a_step_that_leaves_its_state_unchanged_is_caught(cell, monkeypatch):
    from repro_torch.train import optimizer

    def unchanged(cfg, params, grads, state, decay=None, split=None):
        return params, optimizer.OptState(state.step + 1, state.m, state.v), \
            {"grad_norm": optimizer.global_norm(grads), "lr": 0.0}
    monkeypatch.setattr(optimizer, "apply_updates", unchanged)
    res = run(cell)
    assert not res["correct"]
    assert res["checks"]["change_gap"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_the_batch_left_out_is_caught(cell, monkeypatch):
    from repro_torch.train import train_step
    monkeypatch.setattr(train_step, "shard_batch", lambda mesh, batch: {
        k: v[:len(v) // 2] for k, v in batch.items()})
    assert not run(cell)["correct"]

