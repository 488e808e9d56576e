"""The backward passes of the training path's kernels, on the CPU.

Each plain backward in ``repro_torch/kernels/ref.py`` (``rmsnorm_bwd``,
``attention_bwd``, ``moe_gmm_bwd``), written as explicit formulas, is
held to two references on the same NumPy inputs: ``torch.autograd`` of
the plain forward, and ``jax.vjp`` of the JAX package's reference
(``repro/kernels/ref.py``), both within 1e-5 in float32. The
``autograd.Function`` of each kernel (``RMSNormFn``,
``FlashAttentionFn``, ``MoeGmmFn``) is held to them on CPU tensors, where
its forward and backward are the plain versions. Attention covers causal
and windowed masks, GQA groups of 1, 2 and 3 query heads a kv head,
q aligned to the end of k, and an explicit ``q_offset`` (against JAX
through the keys it can keep: q at offset o attends, causally, to the
first o + Sq keys, which the JAX reference takes end-aligned).
``moe_gmm`` takes a capacity C that is not a multiple of 8.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.kernels import ref as jref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    torch.set_num_threads(1)


def _np(*shapes, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _autograd(fn, arrays, dout):
    ins = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    out = fn(*ins)
    out.backward(torch.from_numpy(dout))
    return [t.grad.numpy() for t in ins]


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))
    assert err <= TOL, (what, err)


@pytest.mark.parametrize("rows,d", [(1, 8), (7, 64), (33, 200)])
def test_rmsnorm_backward(rows, d):
    x, s, dy = _np((rows, d), (d,), (rows, d), seed=d)
    x *= 3
    s = 1 + 0.1 * s
    dx, ds = ref.rmsnorm_bwd(*(torch.from_numpy(a) for a in (x, s, dy)))
    auto = _autograd(ref.rmsnorm, (x, s), dy)
    _, vjp = jax.vjp(jref.rmsnorm, jnp.asarray(x), jnp.asarray(s))
    jdx, jds = vjp(jnp.asarray(dy))
    fn = _autograd(rms.rmsnorm, (x, s), dy)        # RMSNormFn on the CPU
    for got, what in (((dx, ds), "plain"), (fn, "RMSNormFn")):
        _close(got[0], auto[0], f"{what} dx vs autograd")
        _close(got[1], auto[1], f"{what} dscale vs autograd")
        _close(got[0], jdx, f"{what} dx vs jax")
        _close(got[1], jds, f"{what} dscale vs jax")


# (B, Sq, Sk, H, KV, D, causal, window, q_offset)
ATTN = [(2, 12, 12, 4, 4, 8, True, None, 0),      # group 1
        (1, 20, 20, 4, 2, 16, True, 6, 0),        # group 2, window
        (2, 9, 9, 6, 2, 8, True, None, 0),        # group 3
        (1, 7, 19, 6, 2, 16, True, 5, 0),         # q aligned to k's end
        (1, 8, 30, 3, 1, 8, True, None, 10),      # explicit q_offset
        (1, 16, 16, 4, 2, 8, False, None, 0)]     # not causal


@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,causal,window,q_offset", ATTN)
def test_attention_backward(B, Sq, Sk, H, KV, D, causal, window, q_offset):
    q, k, v, dout = _np((B, Sq, H, D), (B, Sk, KV, D), (B, Sk, KV, D),
                        (B, Sq, H, D), seed=Sq * H + Sk)
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, dout))
    out = ref.attention(tq, tk, tv, **kw)
    plain = ref.attention_bwd(tq, tk, tv, out, tdo, **kw)
    auto = _autograd(lambda a, b, c: ref.attention(a, b, c, **kw),
                     (q, k, v), dout)
    fn = _autograd(lambda a, b, c: fa.flash_attention(a, b, c, **kw),
                   (q, k, v), dout)
    # the JAX reference takes k, v expanded to every query head and q
    # aligned to the end of k: with an explicit offset o, causal, the
    # keys past o + Sq are never kept and are cut off
    n_k = Sk if q_offset == 0 else q_offset + Sq
    g = H // KV

    def jfun(a, b, c):
        return jref.attention(a, jnp.repeat(b, g, axis=2),
                              jnp.repeat(c, g, axis=2), causal=causal,
                              window=window)

    _, vjp = jax.vjp(jfun, jnp.asarray(q), jnp.asarray(k[:, :n_k]),
                     jnp.asarray(v[:, :n_k]))
    jgrads = [np.asarray(t) for t in vjp(jnp.asarray(dout))]
    for i in (1, 2):
        full = np.zeros((B, Sk, KV, D), np.float32)
        full[:, :n_k] = jgrads[i]
        jgrads[i] = full
    for got, what in (([t.numpy() for t in plain], "plain"),
                      (fn, "FlashAttentionFn")):
        for a, b, c, n in zip(got, auto, jgrads, ("dq", "dk", "dv")):
            _close(a, b, f"{what} {n} vs autograd")
            _close(a, c, f"{what} {n} vs jax")


@pytest.mark.parametrize("E,C,d,f", [(3, 13, 16, 24), (2, 8, 40, 8),
                                     (4, 1, 8, 16)])
def test_moe_gmm_backward(E, C, d, f):
    x, w, dy = _np((E, C, d), (E, d, f), (E, C, f), seed=C)
    dx, dw = ref.moe_gmm_bwd(*(torch.from_numpy(a) for a in (x, w, dy)))
    auto = _autograd(ref.moe_gmm, (x, w), dy)
    _, vjp = jax.vjp(jref.moe_gmm, jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    fn = _autograd(gmm.moe_gmm, (x, w), dy)        # MoeGmmFn on the CPU
    for got, what in (((dx, dw), "plain"), (fn, "MoeGmmFn")):
        _close(got[0], auto[0], f"{what} dx vs autograd")
        _close(got[1], auto[1], f"{what} dw vs autograd")
        _close(got[0], jdx, f"{what} dx vs jax")
        _close(got[1], jdw, f"{what} dw vs jax")


def test_functions_take_the_plain_path_only_under_autograd():
    """Without a grad the wrappers call the forward directly (serving's
    path); with one they go through their Functions, whose backward
    passes are the plain ones on the CPU."""
    x, s = (torch.from_numpy(a) for a in _np((4, 8), (8,)))
    with torch.no_grad():
        assert rms.rmsnorm(x, s).grad_fn is None
    y = rms.rmsnorm(x.requires_grad_(True), s)
    assert type(y.grad_fn).__name__ == "RMSNormFnBackward"
