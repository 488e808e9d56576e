"""The dry run's ``pod`` and ``multipod`` cells: one device's step of the
port's "model" axis, counted on ``meta`` (``launch/dryrun.py``).

  * musicgen-large (32 heads on 32 kv heads, a vocab of 2048, an ffn of
    8192: every dim divides 16, no fallback): the counted ``mm`` FLOPs
    and the kernels' of one device of the 16-way model axis, times 16,
    equal the ``card`` count's at the same batch, in a prefill, a
    decode tick and a training step; its all-gathers are those the
    port's placement calls for (the model-axis formula below);
  * ``parallel/sharding.local_shard`` cuts each leaf of every config to
    the bytes ``shard_bytes`` gives for its ``param_shardings`` spec,
    and the blocks of every coordinate tile the leaf;
  * every pod cell of an MoE arch (and its decode tick on multipod)
    reports its FLOPs, its collectives by kind, the port's memory and
    the JAX placement's.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import base as cfgbase  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_dryrun_mesh  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

M = 16


def _cell(kind: str, seq: int):
    name = {"prefill": "prefill_32k", "decode": "decode_32k",
            "train": "train_4k"}[kind]
    return dataclasses.replace(cfgbase.SHAPES[name], seq_len=seq)


def _mm_and_kernels(counter) -> dict:
    out = {"mm": counter.op_flops.get("mm", 0)}
    out.update({k: v["flops"] for k, v in counter.kernels.items()})
    return out


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_split_products_are_a_sixteenth_of_the_card_count(kind):
    cfg = cfgbase.get_config("musicgen-large").scaled(num_layers=2)
    assert not tf.placement(cfg, make_dryrun_mesh("pod"))[1]
    cell = _cell(kind, 256)
    pod = dryrun.device_view(make_dryrun_mesh("pod"))
    split, _, _ = dryrun.count_step(cfg, cell, 2, "meta", pod)
    whole, _, _ = dryrun.count_step(cfg, cell, 2, "meta")
    got, want = _mm_and_kernels(split), _mm_and_kernels(whole)
    assert set(got) == set(want) and got["mm"] > 0
    for k, v in want.items():
        if k == "rmsnorm" or k == "rmsnorm_bwd":
            assert got[k] == v, k                # the norms are replicated
        else:
            assert got[k] * M == v, (k, got[k], v)


def test_prefill_gathers_follow_the_placement():
    """A prefill of B rows of S tokens, in bf16, on one device of 16:
    each layer's attention and FFN output summed over the model ranks
    (an all-gather of 16 times a (B, S, d) partial), its cache's k and v
    gathered over the kv heads (16 x (B, S, 2 KV/16, D)), the embedding
    summed, and the last position's logits gathered (16 x (B, 1, V/16))."""
    cfg = cfgbase.get_config("musicgen-large").scaled(num_layers=2)
    B, S, L = 2, 256, 2
    d, kv, D, V = (cfg.d_model, cfg.num_kv_heads, cfg.resolved_head_dim,
                   cfg.vocab_size)
    pod = dryrun.device_view(make_dryrun_mesh("pod"))
    counter, _, _ = dryrun.count_step(cfg, _cell("prefill", S), B, "meta",
                                      pod)
    item = 2                                     # bf16
    sums = (2 * L + 1) * M * B * S * d * item
    caches = L * M * B * S * 2 * (kv // M) * D * item
    logits = M * B * V // M * item
    assert counter.collectives == {"all-gather": {
        "count": 3 * L + 2, "bytes": sums + caches + logits}}


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "granite-moe-3b-a800m",
                                  "llama4-maverick-400b-a17b", "xlstm-125m"])
def test_local_shard_agrees_with_param_shardings(arch):
    cfg = cfgbase.get_config(arch)
    for mesh in (make_dryrun_mesh("pod"), make_dryrun_mesh("multipod")):
        specs = tf.param_specs(cfg)
        for p, spec in zip(specs, sharding.param_shardings(specs, mesh)):
            t = torch.empty(p.shape, dtype=p.dtype, device="meta")
            coords = {a: mesh.shape[a] - 1 for a in mesh.axis_names}
            block = sharding.local_shard(t, spec, mesh, coords)
            assert block.numel() * p.dtype.itemsize == sharding.shard_bytes(
                p.shape, p.dtype.itemsize, spec, mesh), p.path


def test_blocks_tile_the_leaf():
    mesh = make_dryrun_mesh("pod")
    t = torch.arange(4 * 32 * 512).reshape(4, 32, 512)
    parts = [sharding.local_shard(t, (None, "model", None), mesh,
                                  {"model": r}) for r in range(16)]
    assert torch.equal(torch.cat(parts, dim=1), t)
    parts = [sharding.local_shard(t, (None, None, ("data", "model")), mesh,
                                  {"data": r // 16, "model": r % 16})
             for r in range(256)]
    assert torch.equal(torch.cat(parts, dim=2), t)
    # an axis the coordinates do not name is not cut (data-replicated)
    assert sharding.local_shard(t, ("data", "model", None), mesh,
                                {"model": 3}).shape == (4, 2, 512)


def test_every_pod_cell_is_counted():
    """Every cell of an MoE arch on ``pod``, and its decode tick on
    ``multipod`` too (its other cells count as the pod's at half the
    device's batch; the dense musicgen-large is counted above)."""
    arch = "granite-moe-3b-a800m"
    for cell in cfgbase.cells_for(arch):
        meshes = ("pod", "multipod") if cell.kind == "decode" else ("pod",)
        for mesh in meshes:
            r = dryrun.run_cell(arch, cell.name, mesh)
            assert r["executed"] is True, (arch, cell.name, mesh)
            per = r["per_device"]
            assert per["flops"] > 0 and per["collective_bytes"] > 0
            assert per["collectives"]["all-gather"]["count"] > 0
            assert {"memory", "jax_memory", "sharding_fallbacks",
                    "jax_sharding_fallbacks"} <= set(r)
            # the port replicates over "data" what the JAX places with FSDP
            assert r["memory"]["params_bytes"] >= \
                r["jax_memory"]["params_bytes"]
            ranks = 16 if mesh == "pod" else 32
            want = cell.global_batch // ranks if \
                cell.global_batch % ranks == 0 else cell.global_batch
            assert r["batch_per_device"] == want
