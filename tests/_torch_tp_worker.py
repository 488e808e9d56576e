"""One rank of the port's "model" axis, for
``tests/test_torch_model_axis.py`` (not collected).

    python tests/_torch_tp_worker.py JOB.json

``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` come from the environment,
as torchrun sets them. The rank joins a gloo group through the job's
``file://`` store (60 s timeout), makes the mesh ``make_local_mesh("cpu",
model=job["model"])`` and builds its slice of the smoke model from the
JAX package's parameters the test pickled (``params_from_jax(...,
mesh=mesh)``). Then, each when the job asks for it:

  * ``grads``: the global batch's loss and every gradient
    (``train_step.loss_and_grads``: this rank's data rows, its slice of
    the model: its model shard's slice over "data" where the data axis
    is over 2 ranks), the parameters' ``split_axes()`` and
    ``data_dims`` and the top-k experts each MoE layer routed;
  * ``steps``: that many AdamW steps of ``make_train_step(..., mesh)``,
    each loss, and every parameter after them;
  * ``decode``: a served model of the same slice: the prefill step's
    last logits of the batch's first ``prompt`` tokens (rings of
    ``cache_len`` rows), then one decode step a token of ``ticks``, each
    step's logits, and the rank's rows of every attention ring after the
    prefill and after the last tick. A batch of 1 on a data axis of more
    than one rank is whole on every rank, its rings split over
    ("data", "model") (``train_step.serve_rows``).

Writes the results to ``out`` (``{rank}`` filled in). Runs on the CPU
with one torch thread; imports neither JAX nor the JAX package.
"""
import json
import os
import pickle
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

TIMEOUT = 180          # seconds a spawned group may take


def spawn(tmp, world: int, job: dict) -> list:
    """Run ``world`` ranks of the worker on ``job``; returns each rank's
    output. A rank's failure, or a group that outlasts ``TIMEOUT``,
    fails the test."""
    path = tmp / f"job_tp_{len(list(tmp.iterdir()))}.json"
    path.write_text(json.dumps(job))
    env = {**os.environ, "WORLD_SIZE": str(world),
           "PYTHONPATH": str(ROOT / "src")}
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(path)],
        env={**env, "RANK": str(r), "LOCAL_RANK": str(r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=TIMEOUT))
    finally:
        for p in procs:
            p.kill()
    for r, (p, (out, err)) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}: {out[-2000:]}\n{err[-4000:]}"
    return [torch.load(job["out"].format(rank=r), weights_only=False)
            for r in range(world)]


def rings(caches) -> list:
    """Copies of the attention layers' k, v rows (None for another
    layer)."""
    return [{k: c[k].clone() for k in ("k", "v")} if "k" in c else None
            for c in caches]


def main():
    torch.set_num_threads(1)
    job = json.loads(Path(sys.argv[1]).read_text())
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import moe
    from repro_torch.models.convert import params_from_jax
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as steps

    dist.init_process_group(
        "gloo", init_method=job["init"], rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=timedelta(seconds=60))
    try:
        cfg = get_smoke_config(job["arch"]).scaled(**job["scaled"])
        mesh = make_local_mesh("cpu", model=job["model"])
        with open(job["params"], "rb") as f:
            tree = pickle.load(f)
        batch = torch.load(job["batch"], weights_only=False)
        batch = {k: v.numpy() for k, v in batch.items()}
        out = {"data_rank": mesh.rank, "model_rank": mesh.model_rank}
        routes, real_route = [], moe.route

        def route(*args, **kwargs):
            res = real_route(*args, **kwargs)
            routes.append(res[3].clone())
            return res

        moe.route = route
        model = params_from_jax(cfg, tree, "cpu", trainable=True, mesh=mesh)
        if job.get("grads"):
            loss, grads = steps.loss_and_grads(model, batch, mesh)
            out.update(loss=loss, grads={n: g.clone()
                                         for n, g in grads.items()},
                       split=model.split_axes(),
                       data_dims=dict(model.data_dims), routes=list(routes),
                       fallbacks=model.sharding_fallbacks())
            del grads
        if job.get("steps"):
            ocfg = opt.AdamWConfig(**job["opt"])
            state = opt.init_opt_state(dict(model.named_parameters()))
            step = steps.make_train_step(cfg, ocfg, mesh=mesh)
            out["losses"] = []
            with steps.deterministic():
                for _ in range(job["steps"]):
                    model, state, met = step(model, state, batch)
                    out["losses"].append(met["loss"])
            out["params"] = {n: p.detach().clone()
                             for n, p in model.named_parameters()}
        if job.get("decode"):
            served = params_from_jax(cfg, tree, "cpu", mesh=mesh)
            prefill = steps.make_prefill_step(cfg, mesh, job["cache_len"])
            decode = steps.make_decode_step(cfg, mesh)
            tokens = batch["tokens"][:, :job["prompt"]]
            logits, caches = prefill(served, {"tokens": tokens})
            out["prefill"] = logits
            out["cache_rows"] = [c["k"].shape[1] for c in caches
                                 if "k" in c]
            out["caches"] = rings(caches)
            ticks = torch.load(job["ticks"], weights_only=False)
            pos = torch.full((tokens.shape[0],), tokens.shape[1],
                             dtype=torch.int32)
            out["ticks"] = []
            for t in ticks:
                logits, caches = decode(served, caches,
                                        {"tokens": t, "pos": pos})
                out["ticks"].append(logits)
                pos = pos + 1
            out["final_caches"] = rings(caches)
        torch.save(out, job["out"].format(rank=dist.get_rank()))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
