"""Data-parallel training of the port over ``torch.distributed``, held to
the JAX package's program on the global batch.

Two gloo ranks (spawned as processes, ``tests/_torch_dp_worker.py``,
joined through a ``file://`` store under the test's directory with a 60
s timeout, each process under a time limit) train a smoke config on
their rows of a global batch, each holding its slices of the weights
and AdamW moments (FSDP over "data", the JAX placement). The JAX
package's reference is its train step on the whole batch with
``repro.models.moe.data_group_count`` patched to 2, the program its dry
run installs over 2 data shards (the MoE dispatch routes each shard's
tokens as one group); a placement does not change the JAX program.
Checked (``check_fsdp_ranks_match_jax``, which
``tests/test_torch_fsdp.py`` runs for more configs):

  * the first step's loss within 1e-5 and every gradient (the ranks'
    slices joined in rank order) within 1e-4 (relative to the JAX
    gradient's largest entry) of the JAX package's, and three AdamW
    steps at lr 1e-4 within 1e-5 (the limits of
    ``tests/test_torch_train.py``), for granite-moe-3b-a800m (MoE, its
    aux losses over the ranks; each block rematerialised, so its weights
    are gathered again in the backward) and h2o-danube-1.8b (dense);
  * each rank's gradient slices bit for bit the slices of the same
    step's whole-model gradients summed by ``sum_gradients``;
  * the two ranks' replicated scalars (the losses, gradient norms and
    learning rates) and their whole gradients bit for bit equal, and the
    parameters gathered in rank order after the steps bit for bit equal
    on both ranks (and the ranks' slices joined);
  * a 1-rank group through the same path: the plain trainer's bits.

``tests/test_torch_dp_launch.py`` holds the launcher at world size 2.
"""
import functools
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_dp_worker import spawn  # noqa: E402
from _torch_train_cases import (ARCHS, GRAD_TOL, LOSS_TOL, OPT,  # noqa: E402
                                OPT_J, PARAM_TOL, _model, jax_leaf,
                                make_case)
from repro.configs.base import get_smoke_config as jax_smoke_config  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.train import optimizer as jopt  # noqa: E402
from repro_torch.train import optimizer as opt  # noqa: E402
from repro_torch.train import train_step as steps  # noqa: E402

STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _steps_job(tmp, arch, params, batch, remat):
    store = tmp / f"store_{arch}_{remat}"
    torch.save({n: p.detach() for n, p in params.items()},
               tmp / "params.pt")
    torch.save({k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()},
               tmp / "batch.pt")
    return {"mode": "steps", "init": f"file://{store}", "arch": arch,
            "remat": remat, "params": str(tmp / "params.pt"),
            "batch": str(tmp / "batch.pt"), "steps": STEPS,
            "opt": {f: getattr(OPT, f) for f in OPT.__dataclass_fields__},
            "out": str(tmp / ("out_" + arch + "_{rank}.pt"))}


def _jax_reference(case, groups, monkeypatch):
    """The JAX package's loss and gradients of the global batch, and its
    parameters after ``STEPS`` AdamW steps, with ``groups`` MoE groups."""
    arch, _, _, params, _, jbatch = case
    monkeypatch.setattr(jmoe, "data_group_count", lambda: groups)
    cfg = jax_smoke_config(arch).scaled(remat=False)
    value_and_grad = jax.jit(jax.value_and_grad(
        functools.partial(jtf.train_loss, cfg)))
    update = jax.jit(functools.partial(jopt.apply_updates, OPT_J))
    loss, grads = value_and_grad(params, jbatch)
    jparams, jstate, losses = params, jopt.init_opt_state(params), []
    for _ in range(STEPS):
        jl, jg = value_and_grad(jparams, jbatch)
        jparams, jstate, _ = update(jparams, jg, jstate)
        losses.append(float(jl))
    return float(loss), grads, losses, jparams


def joined(ranks, key: str, name: str) -> torch.Tensor:
    """The ranks' slices of parameter ``name``'s ``key`` tree (grads or
    params) joined in rank order on its sliced dim; the first rank's
    where the parameter is whole."""
    d = ranks[0]["data_dims"].get(name)
    if d is None:
        return ranks[0][key][name]
    return torch.cat([r[key][name] for r in ranks], dim=d)


def check_fsdp_ranks_match_jax(arch, remat, tmp_path, monkeypatch):
    case = make_case(arch)
    _, _, cfg, params, batch, _ = case
    assert ARCHS[arch][0] % 2 == 0
    model = _model(cfg, params)
    job = _steps_job(tmp_path, arch, dict(model.named_parameters()), batch,
                     remat)
    ranks = spawn(tmp_path, 2, job)
    r0, r1 = ranks
    dims = r0["data_dims"]
    assert dims and dims == r1["data_dims"]
    # each rank's slices: the slices of sum_gradients' sum of the whole
    for r in ranks:
        for n, g in r["grads"].items():
            assert torch.equal(g, r["ref_grads"][n]), n
    # the ranks agree bit for bit on every replicated scalar and tensor
    assert torch.equal(r0["loss"], r1["loss"])
    for n in r0["grads"]:
        if n not in dims:
            assert torch.equal(r0["grads"][n], r1["grads"][n]), n
    for a, b in zip(r0["metrics"], r1["metrics"]):
        assert a.keys() == b.keys() == {"loss", "grad_norm", "lr"}
        assert all(torch.equal(a[k], b[k]) for k in a)
    for n in r0["params"]:
        assert torch.equal(r0["gathered"][n], r1["gathered"][n]), n
        assert torch.equal(r0["gathered"][n], joined(ranks, "params", n)), n
    # and hold the JAX package's program on the global batch
    jloss, jgrads, jlosses, jparams = _jax_reference(case, 2, monkeypatch)
    assert abs(float(r0["loss"]) - jloss) <= LOSS_TOL, (arch, jloss)
    assert len(r0["grads"]) == len(list(model.parameters()))
    for name in r0["grads"]:
        g = joined(ranks, "grads", name)
        want = jax_leaf(jgrads, name, cfg)
        assert g.shape == want.shape, name
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(g.numpy() - want).max()) / scale
        assert err <= GRAD_TOL, (arch, name, err)
    for got, want in zip(r0["losses"], jlosses):
        assert abs(float(got) - want) <= LOSS_TOL
    for name, p in r0["gathered"].items():
        err = float(np.abs(p.numpy() - jax_leaf(jparams, name, cfg)).max())
        assert err <= PARAM_TOL, (arch, name, err)


@pytest.mark.parametrize("arch,remat", [("granite-moe-3b-a800m", True),
                                        ("h2o-danube-1.8b", False)])
def test_two_ranks_match_jax_on_the_global_batch(arch, remat, tmp_path,
                                                 monkeypatch):
    check_fsdp_ranks_match_jax(arch, remat, tmp_path, monkeypatch)


def test_one_rank_is_the_plain_trainer_bit_for_bit(tmp_path):
    arch = "granite-moe-3b-a800m"
    _, _, cfg, params, batch, _ = make_case(arch)
    model = _model(cfg, params)
    job = _steps_job(tmp_path, arch, dict(model.named_parameters()), batch,
                     False)
    (r0,) = spawn(tmp_path, 1, job)
    loss, grads = steps.loss_and_grads(model, batch)
    assert torch.equal(r0["loss"], loss)
    for n, g in grads.items():
        assert torch.equal(r0["grads"][n], g), n
    del grads
    state = opt.init_opt_state(dict(model.named_parameters()))
    step = steps.make_train_step(cfg, OPT)
    with steps.deterministic():
        for want in r0["losses"]:
            model, state, met = step(model, state, batch)
            assert torch.equal(met["loss"], want)
    for n, p in model.named_parameters():
        assert torch.equal(r0["params"][n], p.detach()), n
