"""rmsnorm's backward on the CPU against the JAX package, in both types.

``ref.rmsnorm_bwd`` (the plain backward the card's kernel is held to) and
``RMSNormFn`` (autograd through ``kernels/rmsnorm.py``, which on CPU
tensors runs the plain forward and backward) are held to ``jax.vjp`` of
the JAX package's ``repro/kernels/ref.py::rmsnorm`` on the same inputs,
made from a NumPy seed: float32 within 1e-4 and bfloat16 within 2e-2 of
the largest entry (x and dy rounded to bfloat16 in both frameworks; dx
rounded once more at the end, dscale float32), the card's tolerances
(``BWD_TOL`` in ``chip_smoke.py``). The rows are the widths of the zoo's
accepted configs, cut to 3 rows.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402

TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # relative to the largest entry
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# d_model of xlstm-125m, granite-moe-3b-a800m, musicgen-large,
# h2o-danube-1.8b, phi4-mini-3.8b, gemma3-12b, jamba-v0.1-52b,
# llama4-maverick-400b-a17b, granite-20b, llava-next-34b
WIDTHS = (768, 1536, 2048, 2560, 3072, 3840, 4096, 5120, 6144, 7168)
ROWS = 3


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    torch.set_num_threads(1)


@jax.jit
def _jax_grads(x, s, dy):
    """dx and dscale of the JAX package's plain norm in each type (x and
    dy cast to it): one compiled program a width (op-by-op ``jax.vjp``
    compiles each operation apart)."""
    return {name: jax.vjp(jref.rmsnorm, x.astype(jdt), s)[1](dy.astype(jdt))
            for name, (_, jdt) in DTYPES.items()}


@functools.lru_cache(maxsize=None)
def _case(d):
    """The inputs of width ``d`` (NumPy, seeded) and the JAX gradients."""
    rng = np.random.default_rng(d)
    x = 3 * rng.standard_normal((ROWS, d)).astype(np.float32)
    s = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    dy = rng.standard_normal((ROWS, d)).astype(np.float32)
    return x, s, dy, _jax_grads(jnp.asarray(x), jnp.asarray(s),
                                jnp.asarray(dy))


def _close(got, want, tol, what):
    got = np.asarray(got, dtype=np.float32)
    want = np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                1e-30)
    assert err <= tol, (what, err)


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("d", WIDTHS)
def test_rmsnorm_bwd_matches_jax_vjp(name, d):
    tdt, jdt = DTYPES[name]
    x, s, dy, grads = _case(d)
    jdx, jds = grads[name]
    assert jdx.dtype == jdt and jds.dtype == jnp.float32
    want = (np.asarray(jdx.astype(jnp.float32)), np.asarray(jds))
    tx, ts, tdy = (torch.from_numpy(x).to(tdt), torch.from_numpy(s),
                   torch.from_numpy(dy).to(tdt))
    dx, ds = ref.rmsnorm_bwd(tx, ts, tdy)
    assert dx.dtype == tdt and ds.dtype == torch.float32
    xg, sg = tx.clone().requires_grad_(True), ts.clone().requires_grad_(True)
    rms.rmsnorm(xg, sg).backward(tdy)               # RMSNormFn on the CPU
    assert rms.rmsnorm_bwd.launches == 0            # no kernel on the CPU
    for (gdx, gds), what in (((dx, ds), "ref.rmsnorm_bwd"),
                             ((xg.grad, sg.grad), "RMSNormFn")):
        _close(gdx.float().numpy(), want[0], TOL[name], f"{what} dx")
        _close(gds.numpy(), want[1], TOL[name], f"{what} dscale")
