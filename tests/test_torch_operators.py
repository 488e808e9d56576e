"""The port's operator family against the JAX package's.

Both packages get the same weights: the JAX package's own init, carried
across with ``params_from_jax``, since ``torch.Generator`` cannot draw
``jax.random``'s numbers. Inputs are made with numpy from a seed.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from repro.core import operators as jops  # noqa: E402
from repro.core.training import _auc as jauc  # noqa: E402
from repro_torch.core import operators as tops  # noqa: E402
from repro_torch.core.training import _auc  # noqa: E402

# the reduced family's four signatures, incl. the full-width operator
FAMILY = [(2, 8, 16, 25), (3, 16, 32, 50), (4, 16, 32, 50), (5, 32, 64, 100)]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """PyTorch's CPU kernels take one thread per core by default; the
    suite runs test files in parallel workers beside JAX's own threads,
    so one thread each keeps the host from being oversubscribed."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(sig, seed):
    """The same arch and weights in both packages."""
    jarch = jops.OperatorArch(f"op{sig}", *sig)
    jp = jops.init_operator(jarch, jax.random.PRNGKey(seed))
    tp = tops.params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jarch, tops.OperatorArch(f"op{sig}", *sig), jp, tp


def _crops(n, size, seed):
    return np.random.default_rng(seed).uniform(
        size=(n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("sig", FAMILY, ids=[f"L{s[0]}c{s[1]}d{s[2]}s{s[3]}"
                                             for s in FAMILY])
def test_apply_and_score_frames_match_jax(sig):
    _, _, jp, tp = _pair(sig, seed=sig[0])
    crops = _crops(5, sig[3], seed=sig[1])
    jl, jc = jops.apply_operator(jp, jnp.asarray(crops))
    tl, tc = tops.apply_operator(tp, torch.from_numpy(crops))
    assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5, atol=1e-5)
    assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    for got, want in zip(tops.score_frames(tp, crops),
                         jops.score_frames(jp, crops)):
        assert got.dtype == np.float32
        assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_params_round_trip_and_init_layout():
    jarch, tarch, jp, tp = _pair((3, 16, 32, 50), seed=3)
    back = tops.params_to_numpy(tp)
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(back)):
        assert b.dtype == np.float32 and np.array_equal(np.asarray(a), b)
    # the port's own init has the JAX package's layout, and repeats
    mine = tops.init_operator(tarch, torch.Generator().manual_seed(0), "cpu")
    again = tops.init_operator(tarch, torch.Generator().manual_seed(0), "cpu")
    shapes = jax.tree_util.tree_map(lambda a: a.shape, jp)
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape),
                                  mine) == shapes
    assert all(torch.equal(a, b) for a, b in
               zip(tops._leaves(mine), tops._leaves(again)))
    assert sum(t.numel() for t in tops._leaves(mine)) == tarch.param_count


def _toy_task(n, size, seed):
    """Noisy frames whose label is a faintly brighter square: hard
    enough that 30 steps reach an AUC near 0.7, not 1."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 0.6, size=(n, size, size, 3)).astype(np.float32)
    y = (rng.uniform(size=n) < 0.3).astype(np.float32)
    q = size // 4
    x[y > 0, q:2 * q, q:2 * q, :] += 0.1
    return x, y, 2.0 * y


def test_train_operator_tracks_jax_training():
    """Same init, same crops, same seed: both packages draw the same
    minibatches and brightness factors and apply the same Adam update.

    Measured on the float32 CPU path: after 1, 5, 15 and 30 steps the
    held-out loss differs by at most ~2e-6 relative and the weights by
    ~1e-6 absolute (convolution and matmul sum in other orders than
    XLA's, and XLA contracts the Adam update into FMAs). The tolerance,
    1e-4 relative on the loss and 1e-4 absolute on the weights, leaves
    room for that drift to grow without hiding a wrong update, which
    moves a weight by up to lr = 2e-3 per step."""
    sig = (2, 8, 16, 25)
    jarch, tarch, jp, tp = _pair(sig, seed=11)
    x, y, c = _toy_task(200, 25, seed=0)
    xv, yv, cv = _toy_task(120, 25, seed=1)
    for steps in (1, 5, 15, 30):
        jq = jops.train_operator(jarch, jp, x, y, c, steps=steps, seed=5)
        tq = tops.train_operator(tarch, tp, x, y, c, steps=steps, seed=5,
                                 device="cpu")
        jloss = float(jops._loss_fn(jq, jnp.asarray(xv), jnp.asarray(yv),
                                    jnp.asarray(cv), True))
        with torch.no_grad():
            tloss = float(tops._loss_fn(tq, torch.from_numpy(xv),
                                        torch.from_numpy(yv),
                                        torch.from_numpy(cv), True))
        assert abs(tloss - jloss) <= 1e-4 * abs(jloss), (steps, tloss, jloss)
        for a, b in zip(jax.tree_util.tree_leaves(jq),
                        jax.tree_util.tree_leaves(tops.params_to_numpy(tq))):
            assert_allclose(b, np.asarray(a), atol=1e-4, rtol=0)
    # validation AUC of the trained operators agrees within 0.02
    jauc_v = jauc(np.asarray(jops.score_frames(jq, xv)[0], np.float64),
                  yv > 0.5)
    tauc_v = _auc(tops.score_frames(tq, xv)[0].astype(np.float64), yv > 0.5)
    assert abs(tauc_v - jauc_v) <= 0.02
    assert tauc_v > 0.6                  # the operator learned something
    # the caller's params are not modified: training is functional
    assert np.array_equal(tp["head"]["w"].numpy(), np.asarray(jp["head"]["w"]))


def test_thresholds_and_gamma_match_jax():
    rng = np.random.default_rng(4)
    scores = rng.uniform(size=400)
    labels = rng.uniform(size=400) < scores
    for err in (0.01, 0.05, 0.2):
        got = tops.calibrate_thresholds(scores, labels, err)
        assert got == jops.calibrate_thresholds(scores, labels, err)
        assert tops.gamma_of(scores, *got) == jops.gamma_of(scores, *got)
    assert tops.gamma_of(np.empty(0), 0.1, 0.9) == 0.0
