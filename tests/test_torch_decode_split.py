"""Decode attention's split plan (``kernels/decode_attention.py``) on the
CPU.

The CUDA kernel's first pass takes ``split_rows(S, D, group, dtype)``
cache rows a block and writes a partial state per (slot, head, split)
into a float32 scratch of ``scratch_floats(B, H, S, D, split)`` floats;
its second pass merges the splits. The kernel runs only on the card
(``tests/test_torch_cuda.py``); here the split size is held to its
contract (it sees neither the batch nor the positions), the scratch to
every split the kernel can write at the served head shapes, and the
wrapper's CPU path to the JAX model's ``decode_attention`` at those head
shapes, at smoke size. Tolerances are ``tests/test_kernels.py``'s: 2e-5
in float32, 2e-2 in bfloat16.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro.models import attention as jattn  # noqa: E402
from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

# the served head shapes: (H, KV, D) of each config whose decode tick the
# kernel runs on the card
SERVED = ("h2o-danube-1.8b", "granite-moe-3b-a800m",
          "llama4-maverick-400b-a17b", "granite-20b", "gemma3-12b")
TYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
         "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
# ring lengths from 1 row to 8192: every length up to 130, then the
# lengths around each multiple of 64 up to 8192
LENGTHS = sorted(set(range(1, 131)) | {
    n + d for n in range(64, 8193, 64) for d in (-1, 0, 1) if n + d <= 8192})


def _heads(arch):
    cfg = get_config(arch)
    return cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim


def test_split_size_sees_neither_the_batch_nor_the_positions():
    assert list(inspect.signature(da.split_rows).parameters) == [
        "S", "D", "group", "dtype"]


@pytest.mark.parametrize("arch", SERVED)
@pytest.mark.parametrize("name", TYPES)
def test_split_is_whole_tiles_and_covers_the_ring(arch, name):
    H, KV, D = _heads(arch)
    dtype = TYPES[name][1]
    for S in LENGTHS:
        split = da.split_rows(S, D, H // KV, dtype)
        assert split > 0 and split % da.TILE_ROWS == 0, (S, split)
        # no split longer than the ring needs: a ring of S rows is at
        # most one split of whole 64-row tiles beyond it
        assert split < S + da.TILE_ROWS or split == da.TILE_ROWS, (S, split)


@pytest.mark.parametrize("arch", SERVED)
@pytest.mark.parametrize("name", TYPES)
def test_scratch_holds_every_split_the_kernel_writes(arch, name):
    """For every ring length and every count of valid rows a slot can
    have (1 to S), the kernel's partial accumulators, (B*H, NS, D), and
    its (max, sum) pairs after them, (B*H, NS) float2, lie inside the
    scratch the wrapper allocates; the pairs start 8-byte aligned."""
    H, KV, D = _heads(arch)
    dtype = TYPES[name][1]
    for B in (1, 8):
        for S in LENGTHS:
            split = da.split_rows(S, D, H // KV, dtype)
            floats = da.scratch_floats(B, H, S, D, split)
            NS = -(-S // split)
            ml_base = B * H * NS * D
            assert ml_base % 2 == 0
            # the largest split index any slot reaches: all S rows valid
            ns_max = -(-S // split)
            assert ns_max <= NS
            last_row = B * H - 1
            acc_end = ((last_row * NS + ns_max - 1) * D + D)
            ml_end = ml_base + 2 * (last_row * NS + ns_max - 1) + 2
            assert acc_end <= ml_base and ml_end <= floats, (B, S, split)


@pytest.mark.parametrize("arch", SERVED)
@pytest.mark.parametrize("name", TYPES)
def test_cpu_path_matches_the_model_at_the_served_heads(arch, name):
    """The served head counts and dims over a short ring (B 3, S 40),
    one slot before the ring fills, one at its last row, one past the
    wrap."""
    H, KV, D = _heads(arch)
    jdt, tdt, tol = TYPES[name]
    B, S = 3, 40
    pos = [17, 39, 57]
    rng = np.random.default_rng(H * 1000 + D)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KV, D)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = ops.decode_attention(tq, tk, tv, torch.tensor(pos))
    assert got.dtype == tdt and got.shape == (B, H, D)
    jq, jk, jv = (jnp.asarray(a).astype(jdt) for a in (q, k, v))
    want = jattn.decode_attention(jq[:, None], jk, jv, H,
                                  pos=jnp.asarray(pos, jnp.int32))[:, 0]
    assert_allclose(got.float().numpy(),
                    np.asarray(want.astype(jnp.float32)), rtol=tol, atol=tol)
