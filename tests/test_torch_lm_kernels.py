"""The port's plain versions of the LM kernels against the JAX package.

On the CPU each wrapper (``repro_torch.kernels.ops``) takes its plain
version; both are held against the Pallas kernel in interpret mode (as
``tests/test_kernels.py`` runs it) and against the JAX model's own
function, at the tolerance of ``tests/test_kernels.py``: 2e-5 in float32
and 2e-2 in bfloat16. Inputs come from NumPy with a seed. The CUDA
kernels themselves run only on the card: ``tests/test_torch_cuda.py``
holds them against these plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro.kernels.decode_attention import decode_attention as pallas_dec  # noqa: E402
from repro.kernels.flash_attention import flash_attention as pallas_fa  # noqa: E402
from repro.kernels.rmsnorm import rmsnorm as pallas_rms  # noqa: E402
from repro.models import attention as jattn, layers as jlayers  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _pair(a, name):
    """The same values in both frameworks, rounded once to the type."""
    jdt, tdt = DTYPES[name]
    return jnp.asarray(a).astype(jdt), torch.from_numpy(a).to(tdt)


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else
                      x.astype(jnp.float32), np.float32)


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("rows,d", [(7, 64), (3, 2560)])
def test_rmsnorm_matches_pallas_and_model(name, rows, d):
    rng = np.random.default_rng(rows * 10 + d)
    jx, tx = _pair(_normal(rng, (rows, d)) * 3.0, name)
    scale = rng.uniform(0.5, 1.5, size=d).astype(np.float32)
    got = ops.rmsnorm(tx, torch.from_numpy(scale), 1e-6)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    want_kernel = pallas_rms(jx, jnp.asarray(scale), eps=1e-6,
                             interpret=True)
    want_model = jlayers.rmsnorm(jx, {"scale": jnp.asarray(scale)}, 1e-6)
    assert_allclose(_np(got), _np(want_kernel), **_tol(name))
    assert_allclose(_np(got), _np(want_model), **_tol(name))
    assert torch.equal(got, ref.rmsnorm(tx, torch.from_numpy(scale)))


def _expand(k, n_heads):
    return jattn.expand_kv(k, n_heads, n_heads)


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("S,H,KV,D,window", [
    (45, 4, 2, 16, 32),      # the smoke config's heads, ragged, windowed
    (100, 4, 1, 32, None),   # ragged causal, 4 query heads per kv head
    (64, 2, 2, 64, 16),      # MHA, narrow band
])
def test_attention_matches_pallas_and_model(name, S, H, KV, D, window):
    """Causal (and windowed) GQA prefill over a length that is no
    multiple of any block, against the Pallas kernel (one block of the
    whole length, k and v expanded) and ``chunked_attention``."""
    rng = np.random.default_rng(S + H + D)
    jq, tq = _pair(_normal(rng, (2, S, H, D)), name)
    jk, tk = _pair(_normal(rng, (2, S, KV, D)), name)
    jv, tv = _pair(_normal(rng, (2, S, KV, D)), name)
    got = ops.attention(tq, tk, tv, causal=True, window=window)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    ke, ve = _expand(jk, H), _expand(jv, H)
    want_kernel = pallas_fa(jq, ke, ve, causal=True, window=window,
                            interpret=True)
    want_model = jattn.chunked_attention(jq, ke, ve, window=window,
                                         kv_chunk=16)
    assert_allclose(_np(got), _np(want_kernel), **_tol(name))
    assert_allclose(_np(got), _np(want_model), **_tol(name))


def test_attention_suffix_alignment_and_offset():
    """Sq < Sk: q rows are the last Sq positions of k unless q_offset
    places them (the Pallas kernel's convention)."""
    rng = np.random.default_rng(3)
    q, k, v = (_normal(rng, s) for s in
               ((1, 24, 2, 16), (1, 56, 2, 16), (1, 56, 2, 16)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = ops.attention(tq, tk, tv, causal=True, window=20)
    want = pallas_fa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, window=20, block_q=8, block_k=8,
                     interpret=True)
    assert_allclose(got.numpy(), np.asarray(want), **_tol("float32"))
    got = ops.attention(tq, tk, tv, causal=True, q_offset=8)
    want = jattn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), q_offset=8)
    assert_allclose(got.numpy(), np.asarray(want), **_tol("float32"))


@pytest.mark.parametrize("name", DTYPES)
@pytest.mark.parametrize("pos", [[0, 5, 31], [40, 32, 100]],
                         ids=["below_S", "at_or_above_S"])
def test_decode_attention_matches_model(name, pos):
    """GQA decode over a 32-row ring with the model's validity mask:
    rows <= pos before the ring wraps, every row once pos >= S."""
    B, S, H, KV, D = 3, 32, 4, 2, 16
    rng = np.random.default_rng(sum(pos))
    jq, tq = _pair(_normal(rng, (B, H, D)), name)
    jk, tk = _pair(_normal(rng, (B, S, KV, D)), name)
    jv, tv = _pair(_normal(rng, (B, S, KV, D)), name)
    tpos = torch.tensor(pos)
    got = ops.decode_attention(tq, tk, tv, tpos)
    assert got.dtype == tq.dtype and got.shape == tq.shape
    want = jattn.decode_attention(jq[:, None], jk, jv, H,
                                  pos=jnp.asarray(pos, jnp.int32))[:, 0]
    # the model rounds p to the cache type before P.V, as the bf16 kernel
    # does; the plain version keeps it float32 (same bound in float32)
    assert_allclose(_np(got), _np(want), **_tol(name))


@pytest.mark.parametrize("name", DTYPES)
def test_decode_attention_without_mask_matches_pallas(name):
    """pos None (or >= S) with KV == H is the Pallas kernel's function."""
    B, S, H, D = 2, 48, 4, 32
    rng = np.random.default_rng(7)
    jq, tq = _pair(_normal(rng, (B, H, D)), name)
    jk, tk = _pair(_normal(rng, (B, S, H, D)), name)
    jv, tv = _pair(_normal(rng, (B, S, H, D)), name)
    want = pallas_dec(jq, jk, jv, interpret=True)
    for pos in (None, torch.tensor([S, 3 * S])):
        got = ops.decode_attention(tq, tk, tv, pos)
        assert_allclose(_np(got), _np(want), **_tol(name))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    x = torch.zeros(4, 16)
    with pytest.raises(TypeError):
        ops.rmsnorm(x.half(), torch.ones(16))
    with pytest.raises(TypeError):
        ops.rmsnorm(x, torch.ones(16, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        ops.rmsnorm(x, torch.ones(8))
    q = torch.zeros(1, 8, 4, 16)
    kv = torch.zeros(1, 8, 3, 16)
    with pytest.raises(ValueError):
        ops.attention(q, kv, kv)                       # 3 does not divide 4
    with pytest.raises(TypeError):
        ops.attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError):
        ops.attention(q, q, q, window=0)
    with pytest.raises(ValueError):
        ops.decode_attention(q[:, 0], q, q, torch.zeros(2, dtype=torch.int32))
    with pytest.raises(ValueError):                    # x on meta, scale not
        ops.rmsnorm(x.to("meta"), torch.ones(16))
    # meta (the dry run) is checked as the card is, and launches nothing
    with pytest.raises(ValueError):
        ops.rmsnorm(torch.zeros(4, 9000, device="meta"),
                    torch.ones(9000, device="meta"))
    y = ops.rmsnorm(x.to("meta"), torch.ones(16, device="meta"))
    assert y.device.type == "meta" and y.shape == x.shape
