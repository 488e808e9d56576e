"""One rank of the port's data-parallel training, for
``tests/test_torch_data_parallel.py`` (not collected).

    python tests/_torch_dp_worker.py JOB.json

``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` come from the environment,
as torchrun sets them; the job file names the mode and its files. Modes:

  * ``steps``: join a gloo group through the job's ``file://`` store (60
    s timeout), load the parameters the test saved into the smoke model,
    then write to ``out`` (``{rank}`` filled in): the loss and every gradient of the global
    batch's first step (``train_step.loss_and_grads``: this rank's rows,
    the gradients summed over the ranks), and each loss and every
    parameter after ``steps`` AdamW steps of ``make_train_step`` on the
    same batch;
  * ``launch``: run ``repro_torch.launch.train`` with the job's
    arguments (it sets up the group from the environment), sending
    itself SIGTERM after step ``sigterm_after`` if this is rank
    ``sigterm_rank``; writes ``run()``'s result to ``out``.

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
    from repro_torch.train import optimizer as opt
    from repro_torch.train import train_step as steps

    dist.init_process_group(
        "gloo", init_method=job["init"], rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]),
        timeout=timedelta(seconds=60))
    try:
        cfg = get_smoke_config(job["arch"]).scaled(remat=job["remat"])
        model = tf.init_model(cfg, torch.Generator().manual_seed(0), "cpu",
                              trainable=True)
        saved = torch.load(job["params"])
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(saved[n])
        batch = {k: v.numpy() for k, v in torch.load(job["batch"]).items()}
        mesh = make_local_mesh("cpu")
        assert mesh.processes == dist.get_world_size()
        loss, grads = steps.loss_and_grads(model, batch, mesh)
        out = {"loss": loss, "grads": {n: g.clone() for n, g in
                                       grads.items()}, "losses": []}
        del grads
        ocfg = opt.AdamWConfig(**job["opt"])
        state = opt.init_opt_state(dict(model.named_parameters()))
        step = steps.make_train_step(cfg, ocfg, mesh=mesh)
        with steps.deterministic():
            for _ in range(job["steps"]):
                model, state, met = step(model, state, batch)
                out["losses"].append(met["loss"])
        out["params"] = {n: p.detach().clone()
                         for n, p in model.named_parameters()}
        torch.save(out, job["out"].format(rank=dist.get_rank()))
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
    {"steps": steps_mode, "launch": launch_mode}[job["mode"]](job)


if __name__ == "__main__":
    main()
