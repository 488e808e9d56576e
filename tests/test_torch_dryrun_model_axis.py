"""The dry run's ``pod`` and ``multipod`` cells: one device's step of the
port's "model" axis and FSDP over "data", counted on ``meta``
(``launch/dryrun.py``).

  * musicgen-large (32 heads on 32 kv heads, a vocab of 2048, an ffn of
    8192: every dim divides 16, no fallback): the counted ``mm`` FLOPs
    and the kernels' of one device of the 16-way model axis, times 16,
    equal the ``card`` count's at the same batch, in a prefill, a
    decode tick and a training step; its all-gathers are those the
    port's placement calls for (the model-axis formula below, and each
    weight's gather over the 16-way data axis);
  * ``parallel/sharding.local_shard`` cuts each leaf of every config to
    the bytes ``shard_bytes`` gives for its ``param_shardings`` spec,
    and the blocks of every coordinate tile the leaf;
  * every pod cell of an MoE arch (and its decode tick on multipod)
    reports its FLOPs, its collectives by kind, the port's memory and
    the JAX placement's, equal field by field but where
    ``dryrun.jax_differences`` lists a cause;
  * for every arch on ``node``, ``pod`` and ``multipod``: the weights',
    gradients' and AdamW moments' bytes of a device's model for training
    (FSDP over "data") equal the JAX placement's, and a served model's
    weights and decode caches at each decode cell too, exactly where
    ``jax_differences`` lists no cause (and differ where it lists one);
    llama4-maverick-400b-a17b's ``train_4k`` on ``pod`` fits a card's
    80 GB;
  * an FSDP cut executed on 2 CPU gloo ranks (``tests/_torch_dp_worker.
    py``) counts what ``meta`` counts for one device of that mesh,
    collectives included: a prefill and a decode tick exactly, a
    training step's collectives and kernels (its other ops differ on
    the CPU by the optimizer's host scalars).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from _torch_dp_worker import spawn  # noqa: E402
from repro_torch.configs import base as cfgbase  # noqa: E402
from repro_torch.kernels import adamw  # noqa: E402
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
    # the view takes its device's 2 rows of the data ranks' together
    split, _, part = dryrun.count_step(cfg, cell, 2 * pod.processes, "meta",
                                       pod)
    whole, _, model = dryrun.count_step(cfg, cell, 2, "meta")
    got, want = _mm_and_kernels(split), _mm_and_kernels(whole)
    assert set(got) == set(want) and got["mm"] > 0
    for k, v in want.items():
        if k == "rmsnorm" or k == "rmsnorm_bwd":
            assert got[k] == v, k                # the norms are replicated
        elif k == "adamw":
            # the update of the parameters the device holds: sliced over
            # "data" too, and the norms' scales not over "model"
            assert (got[k], v) == (_adamw_flops(part), _adamw_flops(model))
        else:
            assert got[k] * M == v, (k, got[k], v)


def _adamw_flops(model) -> int:
    params = dict(model.named_parameters())
    mask = model.decay_mask()
    return adamw.cost(list(params.values()), [mask[n] for n in params])[0]


def test_prefill_gathers_follow_the_placement():
    """A prefill of B rows of S tokens, in bf16, on one device of 16 x 16:
    each layer's attention and FFN output summed over the model ranks
    (an all-gather of 16 times a (B, S, d) partial), its cache's k and v
    gathered over the kv heads (16 x (B, S, 2 KV/16, D)), the embedding
    summed, and the last position's logits gathered (16 x (B, 1, V/16));
    and over "data" every weight's model shard gathered from its 16
    slices of d: a layer's two float32 norm scales and its bf16 wq, wk,
    wv, wo, wg, wu and wo, once each, then the two tables and the final
    norm's scale, once each."""
    cfg = cfgbase.get_config("musicgen-large").scaled(num_layers=2)
    B, S, L = 2, 256, 2
    d, kv, D, V = (cfg.d_model, cfg.num_kv_heads, cfg.resolved_head_dim,
                   cfg.vocab_size)
    H, F = cfg.num_heads, cfg.d_ff
    pod = dryrun.device_view(make_dryrun_mesh("pod"))
    counter, _, _ = dryrun.count_step(cfg, _cell("prefill", S),
                                      B * pod.processes, "meta", pod)
    item = 2                                     # bf16
    sums = (2 * L + 1) * M * B * S * d * item
    caches = L * M * B * S * 2 * (kv // M) * D * item
    logits = M * B * V // M * item
    layer = 2 * d * 4 + (2 * d * H // M * D + 2 * d * kv // M * D +
                         3 * d * F // M) * item
    top = 2 * V // M * d * item + d * 4
    assert counter.collectives == {"all-gather": {
        "count": 3 * L + 2 + 9 * L + 3,
        "bytes": sums + caches + logits + L * layer + top}}


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
                    "jax_sharding_fallbacks", "jax_differences"} <= set(r)
            # FSDP over "data": the JAX placement's bytes, but where a
            # cause is listed
            _check_memory(r["memory"], r["jax_memory"],
                          r["jax_differences"])
            ranks = 16 if mesh == "pod" else 32
            want = cell.global_batch // ranks if \
                cell.global_batch % ranks == 0 else cell.global_batch
            assert r["batch_per_device"] == want


FIELDS = {"weights": ("params_bytes", "grads_bytes", "adamw_bytes"),
          "cache": ("cache_bytes",)}


def _check_memory(port: dict, jax: dict, causes: dict,
                  check=tuple(FIELDS)) -> None:
    """Each field of the port's memory (those of ``check``) equal to the
    JAX placement's exactly where ``causes`` lists nothing for it."""
    for what in check:
        keys = FIELDS[what]
        same = [port[k] == jax[k] for k in keys if port[k] or jax[k]]
        if causes[what]:
            assert same and not all(same), (what, causes[what], port, jax)
        else:
            assert all(same), (what, port, jax)


@pytest.mark.parametrize("arch", cfgbase.ARCH_IDS)
def test_memory_is_the_jax_placements_but_the_listed_causes(arch):
    cfg = cfgbase.get_config(arch)
    train = cfgbase.SHAPES["train_4k"]
    for mesh_name in ("node", "pod", "multipod"):
        mesh = make_dryrun_mesh(mesh_name)
        view = dryrun.device_view(mesh)
        model = tf.init_model(cfg, device="meta", trainable=True, mesh=view)
        jax = dryrun.jax_placement(cfg, train, mesh_name)["memory"]
        _check_memory(dryrun._memory(model, None, True), jax,
                      dryrun.jax_differences(cfg, train, mesh_name))
        served = tf.init_model(cfg, device="meta", mesh=view)
        for cell in cfgbase.cells_for(arch):
            if cell.kind != "decode":
                continue
            caches = tf.init_caches(cfg, cell.global_batch, cell.seq_len,
                                    "meta", mesh=view)
            jax = dryrun.jax_placement(cfg, cell, mesh_name)["memory"]
            _check_memory(dryrun._memory(served, (None, caches), False), jax,
                          dryrun.jax_differences(cfg, cell, mesh_name))


def test_llama4_maverick_trains_within_a_card_on_a_pod():
    r = dryrun.run_cell("llama4-maverick-400b-a17b", "train_4k", "pod")
    assert r["memory"]["fits"] and r["jax_memory"]["fits"]
    assert r["memory"]["total_bytes"] <= dryrun.CARD_MEMORY_BYTES
    _check_memory(r["memory"], r["jax_memory"], r["jax_differences"])


@pytest.mark.parametrize("arch,shape", [
    ("h2o-danube-1.8b", "prefill_32k"), ("granite-moe-3b-a800m", "decode_32k"),
    ("granite-moe-3b-a800m", "train_4k")])
def test_fsdp_cut_counts_what_meta_counts(arch, shape, tmp_path):
    job = {"mode": "dryrun", "init": f"file://{tmp_path}/store",
           "arch": arch, "shape": shape, "batch": 4, "seq": 64,
           "out": str(tmp_path / "out_{rank}.pt")}
    ranks = spawn(tmp_path, 2, job)
    for r in ranks:
        assert r["data"] == 2 and r["reduced"]["data_axis"] == [16, 2]
        assert r["collectives"]["all-gather"]["count"] > 0
        if shape == "train_4k":
            assert not [k for k in r["count_diff"] if k.startswith(
                ("collectives", "kernels"))], r["count_diff"]
        else:
            assert r["count_equal"], r["count_diff"]
    assert [r["data_rank"] for r in ranks] == [0, 1]
    assert ranks[0]["collectives"] == ranks[1]["collectives"]
