"""The scorer's dense and head layers (``kernels/scorer_head.py``) against
the JAX package's.

On the CPU the wrapper takes its plain version (``kernels/ref.py``). The
JAX package's dense and head layers run inside its runtime's scorer body
(``repro/core/runtime.py``), here with no conv layer in the params, so
that the body's input is the flattened features themselves. Inputs come
from NumPy with a seed; probabilities and counts agree within 1e-5. The
CUDA kernel runs only on the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.core import runtime as jrt  # noqa: E402
from repro_torch.core.operators import softplus  # noqa: E402
from repro_torch.kernels import ops as kops, ref  # noqa: E402
from repro_torch.kernels import scorer_head as sh  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(m, feat, dense, seed):
    rng = np.random.default_rng(seed)
    return {"h": rng.uniform(size=(m, feat)).astype(np.float32),
            "wd": (rng.standard_normal((feat, dense)) *
                   np.sqrt(2.0 / feat)).astype(np.float32),
            "bd": (0.1 * rng.standard_normal(dense)).astype(np.float32),
            "wh": (rng.standard_normal((dense, 2)) /
                   np.sqrt(dense)).astype(np.float32),
            "bh": (0.1 * rng.standard_normal(2)).astype(np.float32)}


# (M, feat, dense): the features of op_L2c8s25 (7*7*8), op_L4c16s50
# (4*4*16) and op_L5c32s100 (4*4*32) at dispatch row counts, and a ragged
# feat past one 64-deep chunk of the kernel
@pytest.mark.parametrize("m,feat,dense", [(20, 392, 16), (32, 256, 32),
                                          (64, 512, 64), (7, 131, 64)])
def test_plain_version_matches_the_jax_scorer_body(m, feat, dense):
    a = _inputs(m, feat, dense, seed=m + feat)
    sig = (2, 8, dense, 25)
    body = jrt.OperatorRuntime(backend="jnp")._scorer_body(sig)
    jp, jc = body({"convs": [],
                   "dense": {"w": jnp.asarray(a["wd"]),
                             "b": jnp.asarray(a["bd"])},
                   "head": {"w": jnp.asarray(a["wh"]),
                            "b": jnp.asarray(a["bh"])}},
                  jnp.asarray(a["h"]))
    t = {k: torch.from_numpy(v) for k, v in a.items()}
    before = sh.scorer_head.launches
    out = kops.scorer_head(t["h"], t["wd"], t["bd"], t["wh"], t["bh"])
    assert sh.scorer_head.launches == before     # CPU: the plain version
    assert out.shape == (m, 2)
    assert torch.equal(out, ref.scorer_head(t["h"], t["wd"], t["bd"],
                                            t["wh"], t["bh"]))
    assert_allclose(torch.sigmoid(out[:, 0]).numpy(), np.asarray(jp), **TOL)
    assert_allclose(softplus(out[:, 1]).numpy(), np.asarray(jc), **TOL)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    t = {k: torch.from_numpy(v) for k, v in _inputs(4, 16, 8, 0).items()}
    args = [t[k] for k in ("h", "wd", "bd", "wh", "bh")]
    with pytest.raises(TypeError):
        sh.scorer_head(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        sh.scorer_head(args[0][:, :8], *args[1:])          # feat mismatch
    with pytest.raises(ValueError):
        sh.scorer_head(*args[:3], args[3][:, :1], args[4])  # one head column
    with pytest.raises(ValueError):                    # h on meta, the rest not
        sh.scorer_head(args[0].to("meta"), *args[1:])
    # meta (the dry run) is checked as the card is and launches nothing
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError):                    # more than 64 dense units
        sh.scorer_head(meta[0], torch.zeros(16, 65, device="meta"),
                       torch.zeros(65, device="meta"),
                       torch.zeros(65, 2, device="meta"), meta[4])
    before = sh.scorer_head.launches
    out = sh.scorer_head(*meta)
    assert out.device.type == "meta" and out.shape == (args[0].shape[0], 2)
    assert sh.scorer_head.launches == before
