"""One rank of the port's data-parallel training, for
``tests/test_torch_data_parallel.py`` (not collected).

    python tests/_torch_dp_worker.py JOB.json

``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` come from the environment,
as torchrun sets them; the job file names the mode and its files. Modes:

  * ``steps``: join a gloo group through the job's ``file://`` store (60
    s timeout), build the rank's slice of the smoke model
    (``init_model(..., mesh=make_local_mesh("cpu"))``: FSDP over "data")
    and load its slices of the parameters the test saved, then write to
    ``out`` (``{rank}`` filled in): which dim each parameter is sliced
    on (``data_dims``), the loss and every gradient of the global batch's
    first step (``train_step.loss_and_grads``: this rank's rows, its
    slices of the gradients), the same step's gradients of the whole
    model (every weight on every rank) summed by ``sum_gradients`` and
    cut to this rank's slices (``ref_grads``), each loss, gradient norm
    and learning rate of ``steps`` AdamW steps of ``make_train_step`` on
    the same batch, every parameter after them (this rank's slices,
    ``params``, and the whole ones gathered in rank order,
    ``gathered``);
  * ``launch``: run ``repro_torch.launch.train`` with the job's
    arguments (it sets up the group from the environment), sending
    itself SIGTERM after step ``sigterm_after`` if this is rank
    ``sigterm_rank``; writes ``run()``'s result to ``out``;
  * ``serve``: the rank's slice of the served smoke model from seed 0,
    the prefill step (rings of ``cache_len`` rows) of the job's
    ``tokens`` (this rank's rows of them) and one decode step a tick of
    ``ticks``; writes each step's logits;
  * ``dryrun``: ``launch/dryrun.execute_cell`` of the job's cut as one
    rank of a data axis of the world's size; writes its result.

Runs on the CPU with one torch thread; imports neither JAX nor the JAX
package. ``spawn`` runs a group of ranks for a test.
"""
import contextlib
import json
import os
import signal
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
    path = tmp / f"job_{job['mode']}_{len(list(tmp.iterdir()))}.json"
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
    return [torch.load(job["out"].format(rank=r)) for r in range(world)]


def steps_mode(job):
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.parallel import ops as pops
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as steps

    _group(job)
    try:
        cfg = get_smoke_config(job["arch"]).scaled(remat=job["remat"])
        mesh = make_local_mesh("cpu")
        assert mesh.processes == dist.get_world_size()
        saved = torch.load(job["params"])
        batch = {k: v.numpy() for k, v in torch.load(job["batch"]).items()}

        def built(mesh):
            model = tf.init_model(cfg, torch.Generator().manual_seed(0),
                                  "cpu", trainable=True, mesh=mesh)
            with torch.no_grad():
                for n, p in model.named_parameters():
                    p.copy_(model.slice_of(n, saved[n]))
            return model

        model = built(mesh)
        loss, grads = steps.loss_and_grads(model, batch, mesh)
        out = {"loss": loss, "grads": {n: g.clone() for n, g in
                                       grads.items()},
               "data_dims": dict(model.data_dims), "metrics": []}
        del grads
        _, ref = steps.loss_and_grads(built(None), batch, mesh)
        out["ref_grads"] = {n: model.slice_of(n, g).clone()
                            for n, g in ref.items()}
        del ref
        ocfg = opt.AdamWConfig(**job["opt"])
        state = opt.init_opt_state(dict(model.named_parameters()))
        step = steps.make_train_step(cfg, ocfg, mesh=mesh)
        with steps.deterministic():
            for _ in range(job["steps"]):
                model, state, met = step(model, state, batch)
                out["metrics"].append(met)
        out["losses"] = [m["loss"] for m in out["metrics"]]
        out["params"] = {n: p.detach().clone()
                         for n, p in model.named_parameters()}
        out["gathered"] = {
            n: torch.cat(pops.all_parts(p.detach(), mesh.group),
                         dim=model.data_dims[n])
            if n in model.data_dims else p.detach().clone()
            for n, p in model.named_parameters()}
        torch.save(out, job["out"].format(rank=dist.get_rank()))
    finally:
        dist.destroy_process_group()


def _group(job):
    dist.init_process_group(
        "gloo", init_method=job["init"], rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=timedelta(seconds=60))


def serve_mode(job):
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import transformer as tf
    from repro_torch.train import train_step as steps

    _group(job)
    try:
        cfg = get_smoke_config(job["arch"])
        mesh = make_local_mesh("cpu")
        model = tf.init_model(cfg, torch.Generator().manual_seed(0), "cpu",
                              mesh=mesh)
        data = torch.load(job["data"])
        prefill = steps.make_prefill_step(cfg, mesh, job["cache_len"])
        decode = steps.make_decode_step(cfg, mesh)
        logits, caches = prefill(model, {"tokens": data["tokens"]})
        out = {"prefill": logits, "ticks": [],
               "data_dims": dict(model.data_dims)}
        pos = torch.full((data["tokens"].shape[0],),
                         data["tokens"].shape[1], dtype=torch.int32)
        for t in data["ticks"]:
            logits, caches = decode(model, caches, {"tokens": t, "pos": pos})
            out["ticks"].append(logits)
            pos = pos + 1
        torch.save(out, job["out"].format(rank=dist.get_rank()))
    finally:
        dist.destroy_process_group()


def dryrun_mode(job):
    from repro_torch.configs.base import get_smoke_config
    from repro_torch.launch import dryrun

    _group(job)
    try:
        r = dryrun.execute_cell(job["arch"], job["shape"], "cpu",
                                cfg=get_smoke_config(job["arch"]),
                                batch=job["batch"], seq=job["seq"],
                                data=dist.get_world_size())
        torch.save(r, job["out"].format(rank=dist.get_rank()))
    finally:
        dist.destroy_process_group()


def launch_mode(job):
    from repro_torch.launch import train as launch_train
    rank = int(os.environ["RANK"])

    @contextlib.contextmanager
    def preempt(step):
        yield
        if rank == job.get("sigterm_rank") and \
                step == job.get("sigterm_after"):
            os.kill(os.getpid(), signal.SIGTERM)

    out = launch_train.run(job["argv"], wrap_step=preempt)
    torch.save(out, job["out"].format(rank=rank))


def main():
    torch.set_num_threads(1)
    job = json.loads(Path(sys.argv[1]).read_text())
    {"steps": steps_mode, "launch": launch_mode, "serve": serve_mode,
     "dryrun": dryrun_mode}[job["mode"]](job)


if __name__ == "__main__":
    main()
