"""The port's training launcher at world size 2, and the data-parallel
split's refusals.

``repro_torch.launch.train`` on two gloo ranks (spawned with
``tests/test_torch_data_parallel.py``'s ``spawn``, torchrun's environment
and a ``file://`` store): SIGTERM on rank 0 stops both ranks after the
same step, and they checkpoint (rank 0 writes); ``--resume auto`` then
repeats the uninterrupted run bit for bit, every saved leaf. A batch
whose rows do not divide the ranks raises, and so does a rank routing
fewer tokens than the MoE has experts. The gradient sum's buckets may
cut through tensors.
"""
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dp_worker import spawn  # noqa: E402
from repro_torch.launch.mesh import Mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.parallel import ops as pops, sharding  # noqa: E402
from repro_torch.train import train_step as steps  # noqa: E402


def _final(path):
    root = Path(path) / (Path(path) / "LATEST").read_text()
    manifest = json.loads((root / "manifest.json").read_text())
    return manifest, {k: np.load(root / v["file"])
                      for k, v in manifest["leaves"].items()}


def test_resume_at_world_size_two_is_bit_for_bit(tmp_path):
    """``launch.train`` over 2 ranks, 6 steps straight; the same run with
    SIGTERM on rank 0 after 3 steps (both ranks stop and checkpoint), then
    ``--resume auto`` for the rest: every saved leaf is the straight
    run's."""
    base = ["--arch", "granite-moe-3b-a800m", "--smoke", "--steps", "6",
            "--batch", "4", "--seq", "16", "--ckpt-every", "1000",
            "--log-every", "1000", "--device", "cpu", "--dist-backend",
            "gloo", "--dist-timeout", "60"]

    def run(name, ckpt, **extra):
        job = {"mode": "launch", "out": str(tmp_path / (name + "_{rank}.pt")),
               "argv": base + ["--ckpt", str(tmp_path / ckpt),
                               "--dist-init",
                               f"file://{tmp_path / ('store_' + name)}"] +
               extra.pop("argv", []), **extra}
        return spawn(tmp_path, 2, job)

    straight = run("straight", "a")
    first = run("first", "b", sigterm_rank=0, sigterm_after=2)
    second = run("second", "b", argv=["--resume", "auto"])
    assert all(r["world_size"] == 2 for r in straight + first + second)
    assert [r["stopped"] for r in first] == [True, True]
    assert [r["steps"] for r in first] == [3, 3]
    assert [r["start_step"] for r in second] == [3, 3]
    assert first[0]["losses"] == straight[0]["losses"][:3]
    assert second[0]["losses"] == straight[0]["losses"][3:]
    assert straight[0]["losses"] == straight[1]["losses"]
    (ma, la), (mb, lb) = _final(tmp_path / "a"), _final(tmp_path / "b")
    assert ma["step"] == mb["step"] == 6 and set(la) == set(lb)
    for k in la:
        assert np.array_equal(la[k], lb[k]), k


class _Group:
    """Stands for a process group where no collective runs."""


def test_a_batch_that_does_not_divide_raises():
    mesh = Mesh((torch.device("cpu"),) * 2, ("data", "model"),
                {"data": 2, "model": 1}, group=_Group(), rank=1)
    rows = {"tokens": np.arange(12).reshape(3, 4),
            "labels": np.arange(12).reshape(3, 4)}
    with pytest.raises(ValueError, match="does not divide over 2"):
        steps.shard_batch(mesh, rows)
    four = {k: np.arange(16).reshape(4, 4) for k in ("tokens", "labels")}
    got = steps.shard_batch(mesh, four)
    assert np.array_equal(got["tokens"], four["tokens"][2:])
    assert sharding.data_batch_specs(mesh, four)["tokens"] == ("data", None)
    # a rank routing fewer tokens than experts: the global program would
    # fall back to one group, which a rank cannot
    p = {"router": torch.zeros(4, 8), "wg": torch.zeros(8, 4, 2),
         "wu": torch.zeros(8, 4, 2), "wo": torch.zeros(8, 2, 4)}
    with pops.use_mesh(mesh, sharding.default_rules(mesh)):
        assert pops.data_group_count() == 2 and pops.local_group_count() == 1
        with pytest.raises(ValueError, match="fewer than the 8 experts"):
            moe.moe_forward(torch.zeros(1, 6, 4), p, n_experts=8, top_k=2,
                            capacity_factor=1.25)


def test_gradient_buckets_cut_across_tensors(tmp_path):
    """``sum_gradients`` in a group of one rank, with buckets of 3
    floats cutting through tensors and holding the ends of several: every
    gradient comes back in place with its own bits (the sum over one rank
    is the identity), whatever its type."""
    import torch.distributed as dist
    from datetime import timedelta
    g = torch.Generator().manual_seed(0)
    grads = {"a": torch.randn(5, 2, generator=g),
             "b": torch.randn(1, generator=g),
             "c": torch.randn(7, generator=g).to(torch.bfloat16),
             "d": torch.zeros(0), "e": torch.randn(2, 3, generator=g)}
    want = {k: v.clone() for k, v in grads.items()}
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    try:
        steps.sum_gradients(grads, dist.group.WORLD, bucket_bytes=12)
    finally:
        dist.destroy_process_group()
    for k in want:
        assert grads[k].dtype == want[k].dtype
        assert torch.equal(grads[k], want[k]), k
