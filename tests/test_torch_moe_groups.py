"""The port's grouped MoE dispatch against the JAX package's.

Under ``parallel.ops.use_mesh`` with a 4-slot data axis the port routes
the tokens within G = 4 groups, each with its own sort and capacity; the
JAX package does the same with ``repro.models.moe.data_group_count``
patched to 4 (as ``tests/test_models.py::
test_moe_grouped_dispatch_matches_global`` patches it). Float32, within
1e-5: the output, the aux losses, and the gradients of a loss built from
both. A capacity factor that drops tokens makes the per-group capacity
differ from the global one, so a grouping fault shows; an ample one
checks the plain path. Where the tokens do not divide into groups of at
least ``n_experts``, both fall back to one group.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro.models import layers as jlayers, moe as jmoe  # noqa: E402
from repro_torch.launch.mesh import make_scoring_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.parallel import ops as pops  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
D, FF, E, K = 16, 32, 4, 2
# name -> (capacity factor, x shape, groups the dispatch forms)
CASES = {
    "drops": (0.5, (4, 16, D), 4),
    "ample": (8.0, (4, 16, D), 4),
    "not_dividing": (0.5, (1, 6, D), 1),      # 6 tokens: 6 % 4
    "too_few_tokens": (0.5, (1, 8, D), 1),    # 2 a group, fewer than E
}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _params(seed=7):
    p = jmoe.init_moe(jax.random.PRNGKey(seed), D, FF, E, 0, (), jnp.float32)
    params = jlayers.split_annotated(p)[0]
    tree = {n: torch.from_numpy(np.array(v)) for n, v in params.items()}
    return params, moe.real_experts(tree, E)


def _jax(x, params, cf, groups, monkeypatch):
    monkeypatch.setattr(jmoe, "data_group_count", lambda: groups)

    def loss(pp, xx):
        y, (lb, z) = jmoe.moe_forward(xx, pp, n_experts=E, top_k=K,
                                      capacity_factor=cf,
                                      compute_dtype=jnp.float32)
        return jnp.sum(y ** 2) + 0.01 * lb + 0.001 * z, (y, lb, z)

    (_, aux), grads = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(params, jnp.asarray(x))
    return aux, grads


def _port(x, tp, cf, groups):
    mesh = make_scoring_mesh(["cpu"] * groups)
    ctx = pops.use_mesh(mesh, sharding.default_rules(mesh)) if mesh else \
        pops.use_mesh(None, {})
    leaves = {n: t.clone().requires_grad_(True) for n, t in tp.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    with ctx:
        assert pops.data_group_count() == groups
        y, (lb, z) = moe.moe_forward(xt, leaves, n_experts=E, top_k=K,
                                     capacity_factor=cf)
    loss = (y ** 2).sum() + 0.01 * lb + 0.001 * z
    loss.backward()
    return (y.detach(), lb.detach(), z.detach()), \
        {n: t.grad for n, t in leaves.items()}, xt.grad


@pytest.mark.parametrize("case", CASES)
def test_grouped_dispatch_matches_jax(case, monkeypatch):
    cf, shape, formed = CASES[case]
    params, tp = _params()
    x = np.random.default_rng(len(case)).standard_normal(shape).astype(
        np.float32)
    (jy, jlb, jz), (jg, jgx) = _jax(x, params, cf, 4, monkeypatch)
    (y, lb, z), grads, gx = _port(x, tp, cf, 4)
    assert_allclose(y.numpy(), np.asarray(jy), **TOL)
    assert_allclose([float(lb), float(z)], [float(jlb), float(jz)], **TOL)
    assert_allclose(gx.numpy(), np.asarray(jgx), **TOL)
    for n, g in grads.items():
        want = np.asarray(jg[n])
        want = want[:, :E] if n == "router" else want[:E]
        assert_allclose(g.numpy(), want, **TOL, err_msg=n)
    # one group: the port's plain dispatch, bit for bit where the groups
    # fell back; a different answer where per-group capacity drops other
    # tokens than the global capacity does
    (y1, _, _), _, _ = _port(x, tp, cf, 1)
    dropped = np.all(y.numpy() == 0, axis=-1)
    if formed == 1:
        assert torch.equal(y1, y)
    elif case == "drops":
        assert dropped.any()
        assert not np.allclose(y1.numpy(), y.numpy(), **TOL)
    else:
        assert not dropped.any()
        assert_allclose(y1.numpy(), y.numpy(), **TOL)


def test_aux_losses_do_not_follow_the_groups(monkeypatch):
    """The load-balance and z losses are over all tokens, computed before
    grouping: the same bits with 1 group and 4."""
    params, tp = _params(3)
    x = np.random.default_rng(3).standard_normal((4, 16, D)).astype(
        np.float32)
    (_, lb1, z1), _, _ = _port(x, tp, 0.5, 1)
    (_, lb4, z4), _, _ = _port(x, tp, 0.5, 4)
    assert torch.equal(lb1, lb4) and torch.equal(z1, z4)
