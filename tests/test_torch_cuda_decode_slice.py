"""Decode attention over a slice of each ring, with each head's
log-sum-exp: the "model" axis's tick (``models/attention.py``), on the
card; the tests skip elsewhere. The file imports neither JAX nor the JAX
package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_decode_slice.py

Checked: the slice's output and log-sum-exp against the plain version
(``kernels/ref.py``) at the served head shapes, slots with no valid row
in their slice included (zeros and -inf); the slices of every rank
merged in rank order (``attention.merge_partials``) against the whole
ring; and on the whole ring, that asking for the log-sum-exp leaves the
output's bits. The log-sum-exp is float32 scores' in both types (bf16
products are exact in float32), so it is held to a float32 limit.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ref  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.models import attention  # noqa: E402

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
LSE_TOL = 1e-4
# (H, KV, D): h2o-danube-1.8b, granite-moe-3b-a800m, granite-20b,
# llama4-maverick-400b-a17b, musicgen-large
HEADS = [(32, 8, 80), (24, 8, 64), (48, 1, 128), (40, 8, 128), (32, 32, 64)]
# (ring rows, model ranks)
RINGS = [(4096, 2), (1024, 16), (640, 2)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _inputs(H, KV, D, S, dtype, device, seed=0):
    B = 6
    g = torch.Generator(device=device).manual_seed(seed)
    q = torch.randn((B, H, D), generator=g, device=device).to(dtype)
    k = torch.randn((B, S, KV, D), generator=g, device=device).to(dtype)
    v = torch.randn((B, S, KV, D), generator=g, device=device).to(dtype)
    # slots before, inside and past the ring's wrap, one at position 0
    pos = np.array([0, 5, S // 2 - 1, S // 2 + 3, S - 1, S + 77])
    return q, k, v, torch.tensor(pos, dtype=torch.int32, device=device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("S,m", RINGS)
@pytest.mark.parametrize("H,KV,D", HEADS)
def test_slice_matches_plain_version_and_merges_to_the_ring(
        cuda, dtype, S, m, H, KV, D):
    q, k, v, pos = _inputs(H, KV, D, S, dtype, cuda)
    n = S // m
    parts = []
    for r in range(m):
        ks = k[:, r * n:(r + 1) * n].contiguous()
        vs = v[:, r * n:(r + 1) * n].contiguous()
        before = da.decode_attention.launches
        out, lse = da.decode_attention(q, ks, vs, pos, row0=r * n, rows=S,
                                       lse=True)
        torch.cuda.synchronize()
        assert da.decode_attention.launches == before + 1
        want, wlse = ref.decode_attention(q, ks, vs, pos, row0=r * n,
                                          rows=S, lse=True)
        empty = torch.isinf(wlse)
        assert torch.equal(torch.isinf(lse), empty), r
        assert torch.equal(out[empty[:, 0]],
                           torch.zeros_like(out[empty[:, 0]])), r
        torch.testing.assert_close(out.float(), want.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype])
        torch.testing.assert_close(lse[~empty], wlse[~empty], rtol=LSE_TOL,
                                   atol=LSE_TOL)
        parts.append((out.float(), lse))
    whole = ref.decode_attention(q, k, v, pos)
    torch.testing.assert_close(attention.merge_partials(parts),
                               whole.float(), rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("H,KV,D", HEADS)
def test_the_log_sum_exp_leaves_the_output_bits(cuda, dtype, H, KV, D):
    q, k, v, pos = _inputs(H, KV, D, 4096, dtype, cuda, seed=1)
    whole = da.decode_attention(q, k, v, pos)
    out, _ = da.decode_attention(q, k, v, pos, lse=True)
    assert torch.equal(out, whole)
