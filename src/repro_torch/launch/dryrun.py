"""Dry run of every (arch x shape x mesh) cell: FLOPs, bytes, collectives,
memory and roofline terms of a step, counted on PyTorch's ``meta`` device.

Ported from ``repro/launch/dryrun.py``, which lowers and compiles each
cell for a TPU v5e mesh and reads its cost from the compiled HLO
(``repro/launch/hlo_analysis.py``). The port has no compiled program:
it runs the step itself, through the entry points a user calls
(``train/train_step.make_train_step``, ``make_prefill_step``,
``make_decode_step``), on a model and inputs with no storage
(``transformer.init_model(cfg, device="meta")``, ``launch/specs.py``),
under the op count of ``launch/op_analysis.py``. Nothing is computed or
allocated, so a 400B-parameter model's training step is counted on a
laptop.

Meshes (``launch/mesh.make_dryrun_mesh``):

* ``card`` and ``node`` (``{data: 8}``) are the placements the port
  executes: one card, or eight data-parallel ranks with the parameters
  replicated and the batch split (a batch that does not divide
  replicates). Each is counted from its step, run on ``meta`` at the
  batch of one device: train = ``train_loss`` forward and backward with
  per-block remat, then AdamW's ``apply_updates``; prefill =
  ``transformer.prefill``; decode = ``transformer.decode_step``. The
  node's collectives come from the port's own plan
  (``op_analysis.collective_plan``).
* ``pod`` (16 x 16) and ``multipod`` (2 x 16 x 16) are the JAX package's
  placements: FSDP over "data", heads, ffn and experts over "model". The
  port has no "model" axis and does not run them (``"executed":
  false``): the dry run reports each device's parameter, AdamW and cache
  bytes under ``parallel/sharding.param_shardings`` and
  ``cache_shardings`` with their fallbacks, and the model FLOPs, and
  counts no FLOPs.

The MoE dispatch allocates static capacity rows, whose shapes follow
from the token count, so the counted expert work is the capacity's, not
the routed rows' (on ``meta`` no token is routed); ``active_params``
stays the JAX top-k formula. Decode attention is counted over a full
ring (every cache row valid), as a ``decode_32k`` or ``long_500k`` tick
has it.

``execute_cell`` runs a cell for real on the card (or, asked, the CPU)
at a stated cut of depth and batch, under the same count, and holds its
count to the ``meta`` count of the same cut (equal integers), then
times the step with CUDA events and reads the time against the
roofline terms.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --mesh all

writes one JSON a cell under ``results/dryrun_torch/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.configs import base as cfgbase
from repro_torch.kernels.ops import Device, resolve_device
from repro_torch.launch import op_analysis
from repro_torch.launch import specs as specs_mod
from repro_torch.launch.mesh import DRYRUN_MESHES, make_dryrun_mesh
from repro_torch.models import transformer
from repro_torch.parallel import sharding
from repro_torch.train import optimizer as opt
from repro_torch.train import train_step as steps

# --- H100 SXM 80 GB, per card: the data sheet's values, not measurements
PEAK_BF16_FLOPS = 989e12      # bf16 dense on the tensor cores
PEAK_FP32_FLOPS = 67e12       # fp32 on the CUDA cores (the port keeps TF32 off)
PEAK_BYTES_PER_S = 3.35e12    # HBM3
NVLINK_BYTES_PER_S = 450e9    # NVLink 4, per direction per card
CARD_MEMORY_BYTES = 80e9
PEAKS = {"bfloat16": PEAK_BF16_FLOPS, "float32": PEAK_FP32_FLOPS}
ITERS, WARMUP = 5, 2          # ``execute_cell``'s timed and warm-up steps

NOTES = (
    "MoE expert work follows the dispatch's static capacity rows, not "
    "routed rows (on meta no token is routed)",
    "decode attention is counted over a full ring (every cache row valid)",
    "collectives come from the port's plan (train_step.gradient_buckets, "
    "parallel/ops.gather_sum); sum_gradients' local copies and adds are "
    "not counted",
    "memory counts weights, gradients, AdamW moments and caches, not "
    "activations")


def model_flops(cfg, cell, batch: Optional[int] = None) -> float:
    """MODEL_FLOPS = 6·N_active·D (train) or 2·N_active·D (inference),
    D the tokens of ``batch`` rows (default the cell's global batch), as
    ``repro/launch/dryrun.py::model_flops``."""
    n_active = active_params(cfg)
    B = batch or cell.global_batch
    tokens = B * (cell.seq_len if cell.kind != "decode" else 1)
    mult = 6 if cell.kind == "train" else 2
    return float(mult * n_active * tokens)


def count_params(specs) -> int:
    """Parameters of the JAX package's tree (padded heads and experts
    included), as its ``count_params``."""
    return sum(p.numel for p in specs)


def active_params(cfg) -> int:
    """Parameters touched per token (MoE: top_k and shared experts
    only), as ``repro/launch/dryrun.py::active_params`` reads its tree."""
    total = 0
    for p in transformer.param_specs(cfg):
        n = p.numel
        keys = [str(k) for k in p.path]
        if any(k in ("wg", "wu", "wo") for k in keys) and \
                "ffn" in keys and "router" not in keys:
            if len(p.shape) >= 3 and p.shape[-3] >= 2 and \
                    cfg.num_experts > 0 and p.shape[-3] in (
                        cfg.num_experts, -(-cfg.num_experts // 16) * 16):
                n = n // p.shape[-3] * max(cfg.top_k, 1)
        total += n
    return total


def _nbytes(tree) -> int:
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size() \
        if isinstance(tree, torch.Tensor) else 0


def _random_inputs(cfg, cell, inputs: Dict, gen) -> None:
    """Token ids and prefix embeddings drawn from ``gen`` in place of the
    specs' zeros (not on ``meta``, which holds no values); decode
    positions at the end of the context (a full ring)."""
    for k, t in inputs.items():
        if k in ("tokens", "labels"):
            t.copy_(torch.randint(0, cfg.vocab_size, t.shape,
                                  generator=gen, device=t.device))
        elif k == "prefix_embeds":
            t.copy_(torch.randn(t.shape, generator=gen, device=t.device))
        elif k == "pos":
            t.fill_(cell.seq_len - 1)


def build_step(cfg, cell, device: torch.device, batch: int):
    """(run, model): ``run()`` takes the cell's step once, through the
    step functions a user calls, at ``batch`` rows on ``device``, and
    returns its outputs (the train step's loss, the prefill's logits and
    caches, the decode's logits and caches). Weights and inputs are
    drawn from seed 0 (none on ``meta``); the count does not depend on
    them."""
    gen = None if device.type == "meta" else \
        torch.Generator(device=device).manual_seed(0)
    model = transformer.init_model(cfg, gen, device,
                                   trainable=cell.kind == "train")
    if cell.kind == "decode":
        inputs, caches = specs_mod.decode_specs(cfg, cell, batch, device)
    else:
        inputs = (specs_mod.train_specs if cell.kind == "train" else
                  specs_mod.prefill_specs)(cfg, cell, batch, device)
    if gen is not None:
        _random_inputs(cfg, cell, inputs, gen)
    if cell.kind == "train":
        state = [opt.init_opt_state(dict(model.named_parameters()))]
        step = steps.make_train_step(cfg, opt.AdamWConfig())

        def run():
            _, state[0], metrics = step(model, state[0], inputs)
            return metrics["loss"]
    elif cell.kind == "prefill":
        prefill = steps.make_prefill_step(cfg)

        def run():
            return prefill(model, inputs)
    else:
        decode = steps.make_decode_step(cfg)

        def run():
            return decode(model, caches, inputs)
    return run, model


def count_step(cfg, cell, batch: int, device: Device = "meta"):
    """(the op count of one step, its outputs, the model)."""
    device = resolve_device(device)
    run, model = build_step(cfg, cell, device, batch)
    with op_analysis.count(device.type) as counter:
        out = run()
    return counter, out, model


def roofline(flops_by_class: Dict[str, int], nbytes: int,
             collective_bytes: int = 0) -> dict:
    """Least times of a step: its operations over the card's peak for
    their class (bf16 at the tensor cores' dense rate, the rest at
    fp32's), its bytes over HBM, its collectives over NVLink."""
    compute = sum(n / PEAKS[c] for c, n in flops_by_class.items())
    memory = nbytes / PEAK_BYTES_PER_S
    coll = collective_bytes / NVLINK_BYTES_PER_S
    dominant = max(("compute", compute), ("memory", memory),
                   ("collective", coll), key=lambda kv: kv[1])[0]
    return {"compute_s": compute, "memory_s": memory, "collective_s": coll,
            "dominant": dominant}


def _executed_cell(cfg, cell, mesh_name: str) -> dict:
    """A mesh the port executes: the step counted on ``meta`` at one
    device's rows, the collectives from the port's plan."""
    mesh = make_dryrun_mesh(mesh_name)
    n = mesh.size
    B = cell.global_batch
    split = sharding.data_batch_specs(mesh, torch.empty((B,),
                                                        device="meta"))
    per_device = B // n if split and split[0] is not None else B
    counter, out, model = count_step(cfg, cell, per_device)
    train = cell.kind == "train"
    coll = op_analysis.collective_plan(model, n, train)
    params = _nbytes(list(model.parameters()))
    memory = {"params_bytes": params,
              "grads_bytes": params if train else 0,
              "adamw_bytes": 8 * sum(p.numel() for p in model.parameters())
              if train else 0,
              "cache_bytes": 0 if train else _nbytes(out[1])}
    memory["total_bytes"] = sum(memory.values())
    memory["fits"] = memory["total_bytes"] <= CARD_MEMORY_BYTES
    mf = model_flops(cfg, cell)
    return {"executed": True, "batch_per_device": per_device,
            "per_device": {"flops": counter.flops, "bytes": counter.bytes,
                           "flops_by_class": dict(counter.flops_by_class),
                           "collective_bytes": coll["total_bytes"],
                           "collectives": coll,
                           **counter.tables(),
                           "kernels": counter.summary()["kernels"]},
            "memory": memory,
            "roofline": roofline(counter.flops_by_class, counter.bytes,
                                 coll["total_bytes"]) |
            {"model_flops_global": mf,
             "useful_flops_ratio": mf / max(counter.flops * n, 1)}}


def _placement_cell(cfg, cell, mesh_name: str) -> dict:
    """The JAX placement's per-device bytes (not executed by the port)."""
    mesh = make_dryrun_mesh(mesh_name)
    specs = transformer.param_specs(cfg)
    fallbacks = []
    pspecs = sharding.param_shardings(specs, mesh,
                                      collect_fallbacks=fallbacks)
    params = sum(sharding.shard_bytes(p.shape, p.dtype.itemsize, s, mesh)
                 for p, s in zip(specs, pspecs))
    train = cell.kind == "train"
    adamw = 2 * sum(sharding.shard_bytes(p.shape, 4, s, mesh)
                    for p, s in zip(specs, pspecs)) if train else 0
    cache = 0
    if not train:
        caches = specs_mod.stacked_caches(cfg, transformer.init_caches(
            cfg, cell.global_batch, cell.seq_len, "meta"))
        cspecs = sharding.cache_shardings(cfg, caches, mesh,
                                          cell.global_batch)
        cache = sum(sharding.shard_bytes(t.shape, t.element_size(), s, mesh)
                    for t, s in _pairs(caches, cspecs))
    memory = {"params_bytes": params, "grads_bytes": params if train else 0,
              "adamw_bytes": adamw, "cache_bytes": cache}
    memory["total_bytes"] = sum(memory.values())
    memory["fits"] = memory["total_bytes"] <= CARD_MEMORY_BYTES
    return {"executed": False, "per_device": None, "memory": memory,
            "sharding_fallbacks": sharding.explain_fallbacks(fallbacks),
            "roofline": {"model_flops_global": model_flops(cfg, cell)}}


def _pairs(tree, specs) -> list:
    """(leaf, its spec) of a cache tree and its tree of specs."""
    if isinstance(tree, dict):
        return [x for k in tree for x in _pairs(tree[k], specs[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t, s in zip(tree, specs) for x in _pairs(t, s)]
    return [(tree, specs)]


def run_cell(arch: str, shape_name: str, mesh_name: str) -> dict:
    """One cell's JSON record (the JAX dry run's keys where they carry
    over)."""
    t0 = time.perf_counter()  # noqa: DET001 - the count's own wall time
    cfg = cfgbase.get_config(arch)
    cell = cfgbase.SHAPES[shape_name]
    mesh = make_dryrun_mesh(mesh_name)
    body = (_executed_cell if mesh_name in ("card", "node") else
            _placement_cell)(cfg, cell, mesh_name)
    specs = transformer.param_specs(cfg)
    return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "mesh_shape": dict(mesh.shape), "n_devices": mesh.size,
            "total_params": count_params(specs),
            "active_params": active_params(cfg), **body,
            "notes": list(NOTES),
            "timing": {"count_s":
                       time.perf_counter() - t0}}  # noqa: DET001


def count_diff(a: dict, b: dict) -> dict:
    """The entries in which two ``OpCounter.summary()``s differ, as
    {key: (a's, b's)}, a table's entries under ``table.key``."""
    out = {}
    for k in sorted(set(a) | set(b)):
        x, y = a.get(k), b.get(k)
        if isinstance(x, dict) or isinstance(y, dict):
            x, y = x or {}, y or {}
            out.update({f"{k}.{n}": (x.get(n), y.get(n))
                        for n in sorted(set(x) | set(y))
                        if x.get(n) != y.get(n)})
        elif x != y:
            out[k] = (x, y)
    return out


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_step(run, device: torch.device) -> list:
    """Each of ``ITERS`` steps' time in seconds after ``WARMUP`` steps,
    from CUDA events on the card (the host's clock on the CPU)."""
    for _ in range(WARMUP):
        run()
    _sync(device)
    out = []
    for _ in range(ITERS):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize(device)
            out.append(start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()  # noqa: DET001 - a CPU step's time
            run()
            out.append(time.perf_counter() - t0)  # noqa: DET001
    return out


def execute_cell(arch: str, shape_name: str, device: Device = None, *,
                 layers: Optional[int] = None, batch: Optional[int] = None,
                 seq: Optional[int] = None, cfg=None) -> dict:
    """Run ``arch``'s ``shape_name`` step for real on ``device`` (the card
    unless the caller asks for the CPU), cut to ``layers`` layers and
    ``batch`` rows, under the op count; hold its count to the ``meta``
    count of the same cut (``count_equal``: FLOPs, bytes, FLOPs by
    class, every kernel's calls, FLOPs and bytes, and every aten op's
    calls, all equal); then time ``ITERS`` steps after ``WARMUP``
    (separate, uncounted runs) and
    read the median against the roofline terms: ``roofline_share`` =
    max(compute_s, memory_s) / measured, ``mfu`` = model FLOPs /
    (measured x the bf16 peak). No fallback: a kernel that does not
    build or launch fails the cell.

    ``cfg`` (another config of the arch, in place of the published one)
    and ``seq`` (the cell's tokens) are the narrow cut of the card's
    tests: a smoke-width config at 64 tokens, so that a recurrent
    model's eager scan is counted and run in seconds. Each cut is listed
    in ``reduced``.

    On the CPU a training step's count is not the card's: the
    optimizer's schedule runs on host scalars, which are the step's
    device there."""
    device = resolve_device(device)
    full = cfgbase.get_config(arch)
    cfg = cfg if cfg is not None else full
    if layers is not None and layers != cfg.num_layers:
        if layers % len(cfg.pattern):
            raise ValueError(f"{arch}: {layers} layers is not a whole "
                             f"number of {len(cfg.pattern)}-layer periods")
        cfg = cfg.scaled(num_layers=layers)
    cell = cfgbase.SHAPES[shape_name]
    if seq is not None:
        cell = dataclasses.replace(cell, seq_len=seq)
    B = batch or cell.global_batch
    meta, _, _ = count_step(cfg, cell, B, "meta")
    run, _ = build_step(cfg, cell, device, B)
    with op_analysis.count(device.type) as counter:
        run()
    _sync(device)
    times = time_step(run, device)
    measured = statistics.median(times)
    roof = roofline(counter.flops_by_class, counter.bytes)
    mf = model_flops(cfg, cell, B)
    reduced = {"layers": [full.num_layers, cfg.num_layers],
               "batch": [cfgbase.SHAPES[shape_name].global_batch, B],
               "seq": [cfgbase.SHAPES[shape_name].seq_len, cell.seq_len]}
    if cfg.d_model != full.d_model:
        reduced["d_model"] = [full.d_model, cfg.d_model]
    return {"arch": arch, "shape": shape_name, "device": str(device),
            "reduced": reduced,
            "count_equal": counter.summary() == meta.summary(),
            "count_diff": count_diff(counter.summary(), meta.summary()),
            "flops": counter.flops, "bytes": counter.bytes,
            "meta_flops": meta.flops, "meta_bytes": meta.bytes,
            "kernels": counter.summary()["kernels"],
            "step_s": times, "measured_s": measured, **roof,
            "roofline_share": max(roof["compute_s"], roof["memory_s"]) /
            measured,
            "model_flops": mf, "mfu": mf / (measured * PEAK_BF16_FLOPS)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.dryrun",
        description="Count every (arch x shape x mesh) cell's step on "
                    "PyTorch's meta device; one JSON a cell.")
    ap.add_argument("--arch", default=None, help="arch id or 'all'")
    ap.add_argument("--shape", default=None, help="shape name or 'all'")
    ap.add_argument("--mesh", default="card",
                    choices=list(DRYRUN_MESHES) + ["all"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = cfgbase.ARCH_IDS if args.arch in (None, "all") else [args.arch]
    meshes = DRYRUN_MESHES if args.mesh == "all" else (args.mesh,)
    outdir = Path(args.out)
    outdir.mkdir(parents=True, exist_ok=True)
    n_ok = n_fail = 0
    for arch in archs:
        cells = cfgbase.cells_for(arch)
        if args.shape not in (None, "all"):
            cells = [c for c in cells if c.name == args.shape]
        for cell in cells:
            for mesh in meshes:
                tag = f"{arch}__{cell.name}__{mesh}"
                path = outdir / f"{tag}.json"
                if args.skip_existing and path.exists():
                    ok = json.loads(path.read_text()).get("error") is None
                    print(f"[skip] {tag} ({'ok' if ok else 'FAILED'})")
                    continue
                print(f"[dryrun] {tag} ...", flush=True)
                try:
                    res = run_cell(arch, cell.name, mesh)
                    res["error"] = None
                    n_ok += 1
                    r = res["roofline"]
                    print(f"  ok ({res['timing']['count_s']:.1f} s): " + (
                        f"dominant={r['dominant']} compute={r['compute_s']:.4f}s"
                        f" memory={r['memory_s']:.4f}s coll="
                        f"{r['collective_s']:.4f}s" if res["executed"] else
                        f"placement only, {res['memory']['total_bytes']:.3e}"
                        " bytes a device"), flush=True)
                except Exception as e:  # noqa: BLE001 - record and go on
                    res = {"arch": arch, "shape": cell.name, "mesh": mesh,
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()}
                    n_fail += 1
                    print(f"  FAILED: {type(e).__name__}: {e}", flush=True)
                path.write_text(json.dumps(res, indent=2))
    print(f"dryrun complete: {n_ok} ok, {n_fail} failed")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
