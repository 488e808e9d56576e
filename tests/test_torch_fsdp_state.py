"""FSDP over "data" on gloo ranks spawned as processes
(``tests/_torch_dp_worker.py``), without the JAX package:

  * the prefill and decode steps under FSDP: each rank's logits, its
    rows of the batch, bit for bit one process's on the same rows (a
    served rank routes its rows as one process does);
  * checkpoints hold the whole tree: written by 2 ranks, restored at
    world size 1 into the whole tensors and written again, the same
    files; restored by 2 ranks (each keeping its slices) and written
    again, the same files;
  * no fallback: ``data_gather`` raises with no data axis to gather
    over and on a real tensor with no process group, and a sliced model
    raises outside its mesh.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dp_worker import spawn  # noqa: E402
from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.parallel import ops as pops, sharding  # noqa: E402
from repro_torch.train import checkpoint  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as steps  # noqa: E402

TICKS = 3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "granite-moe-3b-a800m"])
def test_fsdp_prefill_and_decode_rows_are_one_process_rows(arch, tmp_path):
    cfg = get_smoke_config(arch)
    rng = np.random.default_rng(3)
    B, S, cache = 4, 12, 16
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)))
    ticks = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, 1)))
             for _ in range(TICKS)]
    torch.save({"tokens": tokens, "ticks": ticks}, tmp_path / "data.pt")
    job = {"mode": "serve", "init": f"file://{tmp_path}/store",
           "arch": arch, "cache_len": cache, "data": str(tmp_path /
                                                          "data.pt"),
           "out": str(tmp_path / "out_{rank}.pt")}
    ranks = spawn(tmp_path, 2, job)
    assert ranks[0]["data_dims"]
    model = tf.init_model(cfg, torch.Generator().manual_seed(0), "cpu")
    prefill = steps.make_prefill_step(cfg, None, cache)
    decode = steps.make_decode_step(cfg)
    for r, got in enumerate(ranks):
        rows = slice(r * B // 2, (r + 1) * B // 2)
        logits, caches = prefill(model, {"tokens": tokens[rows]})
        assert torch.equal(got["prefill"], logits), r
        pos = torch.full((B // 2,), S, dtype=torch.int32)
        for t, want in zip(ticks, got["ticks"]):
            logits, caches = decode(model, caches, {"tokens": t[rows],
                                                    "pos": pos})
            assert torch.equal(want, logits), r
            pos = pos + 1


def _leaves(path: Path) -> dict:
    manifest = json.loads((path / "manifest.json").read_text())
    return {k: np.load(path / v["file"])
            for k, v in manifest["leaves"].items()}


def test_checkpoints_cross_world_sizes(tmp_path):
    """``launch.train`` at world size 2 for 2 steps; then at world size 1
    resumed from it (no step left: it restores the whole tensors and
    writes them again), then at world size 2 resumed from that (each
    rank keeps its slices, and gathers them to write): the three
    checkpoints hold the same leaves, and ``restore_latest`` of the
    last gives one process the whole model's tensors."""
    ckpt = tmp_path / "ckpt"
    base = ["--arch", "granite-moe-3b-a800m", "--smoke", "--batch", "4",
            "--seq", "16", "--log-every", "1000", "--device", "cpu",
            "--dist-backend", "gloo", "--dist-timeout", "60", "--ckpt",
            str(ckpt)]

    def run(name, world, steps_, resume):
        job = {"mode": "launch", "out": str(tmp_path / (name + "_{rank}.pt")),
               "argv": base + ["--steps", str(steps_), "--dist-init",
                               f"file://{tmp_path / ('store_' + name)}"] +
               (["--resume", "auto"] if resume else [])}
        return spawn(tmp_path, world, job)

    two = run("two", 2, 2, False)
    assert [r["world_size"] for r in two] == [2, 2]
    one = run("one", 1, 2, True)
    assert one[0]["world_size"] == 1 and one[0]["start_step"] == 2
    again = run("again", 2, 3, True)
    assert [r["start_step"] for r in again] == [3, 3]
    a, b, c = (_leaves(ckpt / f"step_{s:09d}") for s in (2, 3, 4))
    assert set(a) == set(b) == set(c)
    for k in a:
        assert np.array_equal(a[k], b[k]) and np.array_equal(a[k], c[k]), k
    cfg = get_smoke_config("granite-moe-3b-a800m")
    model = tf.init_model(cfg, torch.Generator().manual_seed(0), "cpu",
                          trainable=True)
    params = dict(model.named_parameters())
    tree, manifest = checkpoint.restore_latest(
        str(ckpt), {"params": params, "opt": opt.init_opt_state(params)})
    assert manifest["step"] == 4
    for n, p in params.items():
        got = tree["params"][n]
        assert got.shape == p.shape
        assert np.array_equal(got.numpy(), a[f"params/{n}"]), n


def test_no_fallback_without_a_process_group():
    w = torch.ones(4, 2)
    with pytest.raises(RuntimeError, match="no data axis"):
        pops.data_gather(w, 0)
    dry = Mesh((), ("data", "model"), {"data": 2, "model": 1})
    with pops.use_mesh(dry, sharding.default_rules(dry)):
        assert pops.data_slices() == 2
        assert pops.data_gather(w.to("meta"), 0).shape == (8, 2)
        with pytest.raises(RuntimeError, match="no process group"):
            pops.data_gather(w, 0)
    cfg = get_smoke_config("h2o-danube-1.8b")
    model = tf.init_model(cfg, device="meta", mesh=dry)
    assert model.data_dims and model.split_axes()["embed"] == ("data",)
    with pytest.raises(ValueError, match="slice 0 of a data axis of 2"):
        tf.prefill(model, torch.zeros(1, 4, dtype=torch.long,
                                      device="meta"))
