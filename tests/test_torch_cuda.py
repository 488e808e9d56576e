"""Tests of the port that need an NVIDIA card; they skip elsewhere.

The file imports neither JAX nor the JAX package, so it runs on a
machine with only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.core import operators as ops  # noqa: E402
from repro_torch.core import runtime as rt_mod  # noqa: E402
from repro_torch.kernels import build, conv_scorer as cs, ref  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.kernels import scorer_head as sh  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402
from repro_torch.train import train_step as steps  # noqa: E402

pytestmark = pytest.mark.cuda

# (H, Cin, Cout) of every conv layer of the reduced operator family
FAMILY_LAYERS = [(25, 3, 8), (13, 8, 8), (50, 3, 16), (25, 16, 16),
                 (13, 16, 16), (7, 16, 16), (100, 3, 32), (50, 32, 32),
                 (25, 32, 32), (13, 32, 32), (7, 32, 32)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _inputs(n, h, cin, cout, seed, device):
    rng = np.random.default_rng(seed)
    arrays = (rng.standard_normal((n, h, h, cin)),
              rng.standard_normal((3, 3, cin, cout)) / np.sqrt(9 * cin),
              rng.standard_normal((cout,)))
    return [torch.from_numpy(a.astype(np.float32)).to(device)
            for a in arrays]


@pytest.mark.parametrize("i", range(len(FAMILY_LAYERS)),
                         ids=[f"H{h}_{ci}to{co}" for h, ci, co in FAMILY_LAYERS])
def test_kernel_matches_plain_version(cuda, i):
    """At N 1024 within 1e-4 of the plain version (cuDNN in full
    float32), and each output independent of N: the batch's first 1, 2, 5
    and 33 images and its last 33 give the same bits alone."""
    h, cin, cout = FAMILY_LAYERS[i]
    x, w, b = _inputs(1024, h, cin, cout, seed=i, device=cuda)
    before = cs.conv_scorer.launches
    got = cs.conv_scorer(x, w, b)
    torch.cuda.synchronize()
    assert cs.conv_scorer.launches == before + 1
    assert_allclose(got.cpu().numpy(), ref.conv_scorer(x, w, b).cpu().numpy(),
                    rtol=1e-4, atol=1e-4)
    for n in (1, 2, 5, 33):
        assert torch.equal(cs.conv_scorer(x[:n].contiguous(), w, b), got[:n])
    # a copy: the last images' slice need not be 16-byte aligned
    assert torch.equal(cs.conv_scorer(x[-33:].clone(), w, b), got[-33:])


def test_kernel_rejects_what_it_does_not_take(cuda):
    x, w, b = _inputs(4, 25, 3, 8, seed=0, device=cuda)
    with pytest.raises(ValueError):
        cs.conv_scorer(x.permute(0, 2, 1, 3), w, b)     # not contiguous
    with pytest.raises(ValueError):
        cs.conv_scorer(x, w.cpu(), b)                    # mixed devices
    with pytest.raises(TypeError):
        cs.conv_scorer(x.half(), w, b)
    with pytest.raises(ValueError, match="Cout"):
        cs.conv_scorer(x, w[..., :4].contiguous(), b[:4])


def test_runtime_scores_through_the_kernel(cuda):
    """The default runtime is the card; its scores agree with the plain
    forward within 1e-5, and the small and bucketed layers agree with
    each other. 20 frames take 64 rows in the bucketed layer
    and 32 in the small one."""
    arch = ops.OperatorArch("cuda", 5, 32, 64, 100)
    params = ops.init_operator(arch, torch.Generator().manual_seed(0))
    crops = np.random.default_rng(0).uniform(
        size=(20, 100, 100, 3)).astype(np.float32)
    rt = rt_mod.OperatorRuntime()
    assert rt.device.type == "cuda"
    before = cs.conv_scorer.launches
    p, c = rt.score_crops(params, arch, crops)
    assert cs.conv_scorer.launches == before + arch.conv_layers
    ep, ec = ops.score_frames(params, crops)
    assert_allclose(p, ep, rtol=1e-5, atol=1e-5)
    assert_allclose(c, ec, rtol=1e-5, atol=1e-5)
    small = rt_mod.OperatorRuntime(small_flops=float("inf"))
    ps, cs_ = small.score_crops(params, arch, crops)
    assert small.small_calls == 1
    assert [s[0] for v in rt.shape_vocab().values() for s in v] == [64]
    assert [s[0] for v in small.shape_vocab().values() for s in v] == [32]
    assert_allclose(ps, p, rtol=0, atol=1e-6)
    assert_allclose(cs_, c, rtol=0, atol=1e-6)
    # and bit for bit: the convs and the dense and head layers reduce each
    # row in an order that does not depend on the row count
    assert np.array_equal(ps, p) and np.array_equal(cs_, c)


@pytest.mark.parametrize("m", [1, 20, 32, 64, 1024])
def test_scorer_head_matches_plain_version_row_by_row(cuda, m):
    """Within 1e-5 of the plain version, and a row's bits depend neither
    on M nor on the row's place (op_L5c32s100's 512 features, 64 dense
    units)."""
    g = torch.Generator().manual_seed(m)
    h = torch.rand(m, 512, generator=g).to(cuda)
    wd = (torch.randn(512, 64, generator=g) * (2 / 512) ** 0.5).to(cuda)
    bd = (0.1 * torch.randn(64, generator=g)).to(cuda)
    wh = (torch.randn(64, 2, generator=g) / 8).to(cuda)
    bh = (0.1 * torch.randn(2, generator=g)).to(cuda)
    before = sh.scorer_head.launches
    got = sh.scorer_head(h, wd, bd, wh, bh)
    torch.cuda.synchronize()
    assert sh.scorer_head.launches == before + 1
    assert_allclose(got.cpu().numpy(),
                    ref.scorer_head(h, wd, bd, wh, bh).cpu().numpy(),
                    rtol=1e-5, atol=1e-5)
    assert torch.equal(sh.scorer_head(h[:1].contiguous(), wd, bd, wh, bh),
                       got[:1])
    assert torch.equal(sh.scorer_head(h.flip(0).contiguous(), wd, bd, wh, bh),
                       got.flip(0))
    with pytest.raises(ValueError, match="dense"):
        sh.scorer_head(h, torch.zeros(512, 65, device=cuda),
                       torch.zeros(65, device=cuda),
                       torch.zeros(65, 2, device=cuda), bh)


# (feat, dense) of the operator family's heads: op_L2c8s25 (7*7*8, 16),
# op_L3c16s50 (7*7*16, 32), op_L4c16s50 (4*4*16, 32), op_L5c32s100
# (4*4*32, 64), and a ragged feat past two 64-deep chunks
FAMILY_HEADS = [(392, 16), (784, 32), (256, 32), (512, 64), (131, 64)]


@pytest.mark.parametrize("feat,dense", FAMILY_HEADS)
def test_scorer_head_rows_are_bit_equal_across_m(cuda, feat, dense):
    """The same 1024 rows scored at M 1024, and their first and last 1,
    20, 32 and 64 alone, give the same bits: the dispatch layers' row
    counts (the small layer's 32, the bucketed 64, a chunk's 1024)."""
    g = torch.Generator().manual_seed(feat + dense)
    h = torch.rand(1024, feat, generator=g).to(cuda)
    wd = (torch.randn(feat, dense, generator=g) * (2 / feat) ** 0.5).to(cuda)
    bd = (0.1 * torch.randn(dense, generator=g)).to(cuda)
    wh = (torch.randn(dense, 2, generator=g) / dense ** 0.5).to(cuda)
    bh = (0.1 * torch.randn(2, generator=g)).to(cuda)
    full = sh.scorer_head(h, wd, bd, wh, bh)
    assert_allclose(full.cpu().numpy(),
                    ref.scorer_head(h, wd, bd, wh, bh).cpu().numpy(),
                    rtol=1e-5, atol=1e-5)
    for m in (1, 20, 32, 64):
        assert torch.equal(sh.scorer_head(h[:m].clone(), wd, bd, wh, bh),
                           full[:m]), m
        assert torch.equal(sh.scorer_head(h[-m:].clone(), wd, bd, wh, bh),
                           full[-m:]), m


# -- the grouped launches of the stacked superbatch ---------------------------

@pytest.mark.parametrize("q", [2, 3, 8])
@pytest.mark.parametrize("i", range(len(FAMILY_LAYERS)),
                         ids=[f"H{h}_{ci}to{co}" for h, ci, co in FAMILY_LAYERS])
def test_grouped_conv_members_equal_the_ungrouped_kernel(cuda, i, q):
    """One launch for Q members; member m's output is bit for bit the
    ungrouped kernel's on (x[m], w[m], b[m]), and within 1e-4 of the
    plain version."""
    h, cin, cout = FAMILY_LAYERS[i]
    parts = [_inputs(64, h, cin, cout, seed=100 * i + m, device=cuda)
             for m in range(q)]
    x, w, b = (torch.stack([p[k] for p in parts]) for k in range(3))
    before = (cs.conv_scorer.launches, cs.conv_scorer.grouped_launches)
    got = cs.conv_scorer(x, w, b)
    torch.cuda.synchronize()
    assert (cs.conv_scorer.launches, cs.conv_scorer.grouped_launches) == \
        (before[0] + 1, before[1] + 1)
    assert got.shape == (q, 64, -(-h // 2), -(-h // 2), cout)
    for m in range(q):
        assert torch.equal(got[m], cs.conv_scorer(*parts[m])), m
    assert_allclose(got.cpu().numpy(),
                    ref.conv_scorer_grouped(x, w, b).cpu().numpy(),
                    rtol=0, atol=1e-4)


@pytest.mark.parametrize("q", [2, 3, 8])
@pytest.mark.parametrize("m", [1, 20, 64, 1024])
@pytest.mark.parametrize("feat,dense", FAMILY_HEADS[:4])
def test_grouped_scorer_head_members_equal_the_ungrouped_kernel(
        cuda, feat, dense, m, q):
    """One launch for Q members, each member bit for bit the ungrouped
    kernel's, at the M where the rows a thread (R) flips from 1 to 2 at
    64 dense units (M 1024) and where it does not."""
    g = torch.Generator().manual_seed(feat + m + q)
    args = [t.to(cuda) for t in (
        torch.rand(q, m, feat, generator=g),
        torch.randn(q, feat, dense, generator=g) * (2 / feat) ** 0.5,
        0.1 * torch.randn(q, dense, generator=g),
        torch.randn(q, dense, 2, generator=g) / dense ** 0.5,
        0.1 * torch.randn(q, 2, generator=g))]
    before = (sh.scorer_head.launches, sh.scorer_head.grouped_launches)
    got = sh.scorer_head(*args)
    torch.cuda.synchronize()
    assert (sh.scorer_head.launches, sh.scorer_head.grouped_launches) == \
        (before[0] + 1, before[1] + 1)
    for j in range(q):
        # a member's own tensors (a slice of bh is not 16-byte aligned)
        own = [a[j].clone() for a in args]
        assert torch.equal(got[j], sh.scorer_head(*own)), j
    assert_allclose(got.cpu().numpy(),
                    ref.scorer_head_grouped(*args).cpu().numpy(),
                    rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sig", [(2, 8, 16, 25), (5, 32, 64, 100)])
def test_superbatch_equals_bucketed_layer(cuda, sig):
    """A stacked superbatch of 3 members launches each conv layer and
    the head once, and each member equals the bucketed layer on its own
    chunk and params bit for bit."""
    arch = ops.OperatorArch("sb", *sig)
    params = [ops.init_operator(arch, torch.Generator().manual_seed(g))
              for g in range(3)]
    x = np.random.default_rng(sig[0]).uniform(
        size=(3, 64, sig[3], sig[3], 3)).astype(np.float32)
    rt = rt_mod.OperatorRuntime()
    before = (cs.conv_scorer.launches, sh.scorer_head.launches)
    gp, gc = rt._dispatch(sig, rt_mod.stack_params(params), x, kind="super")
    torch.cuda.synchronize()
    assert (cs.conv_scorer.launches - before[0],
            sh.scorer_head.launches - before[1]) == (sig[0], 1)
    for g in range(3):
        p, c = rt._dispatch(sig, params[g], x[g], kind="bucketed")
        assert torch.equal(gp[g], p) and torch.equal(gc[g], c), g


def test_pinned_staging_is_not_refilled_under_a_copy(cuda):
    """Six same-shape chunks dispatched back to back, each copied from a
    page-locked block of PyTorch's caching host allocator while the card
    is held busy, their sources overwritten before any result is read:
    no block was handed out again under a queued copy, so every result
    is its own chunk's, bit for bit the result of that chunk scored
    alone."""
    arch = ops.OperatorArch("pin", 5, 32, 64, 100)
    params = ops.init_operator(arch, torch.Generator().manual_seed(0))
    sig = rt_mod.arch_signature(arch)
    rng = np.random.default_rng(0)
    chunks = [rng.uniform(size=(1024, 100, 100, 3)).astype(np.float32)
              for _ in range(6)]
    alone = rt_mod.OperatorRuntime()
    want = []
    for x in chunks:
        p, c = alone._dispatch(sig, params, x, kind="bucketed")
        want.append((p.cpu(), c.cpu()))
    rt = rt_mod.OperatorRuntime()
    torch.cuda._sleep(50_000_000)       # hold the card: the copies queue
    outs = [rt._dispatch(sig, params, x, kind="bucketed") for x in chunks]
    for x in chunks:
        x[:] = -1.0
    torch.cuda.synchronize()
    for (p, c), (wp, wc) in zip(outs, want):
        assert torch.equal(p.cpu(), wp) and torch.equal(c.cpu(), wc)
    assert rt.pinned_copies == 6


def test_training_runs_on_the_card(cuda):
    arch = ops.OperatorArch("cuda_train", 2, 8, 16, 25)
    rng = np.random.default_rng(1)
    crops = rng.uniform(size=(64, 25, 25, 3)).astype(np.float32)
    labels = (rng.uniform(size=64) < 0.3).astype(np.float32)
    params = ops.train_operator(arch, None, crops, labels, labels, steps=3)
    assert all(t.device.type == "cuda" for t in ops._leaves(params))
    again = ops.train_operator(arch, None, crops, labels, labels, steps=3)
    assert all(torch.equal(a, b) for a, b in
               zip(ops._leaves(params), ops._leaves(again)))


# -- the LM kernels -----------------------------------------------------------

LM_DTYPES = {"float32": (torch.float32, 2e-5), "bfloat16": (torch.bfloat16, 2e-2)}


def _randn(shape, dtype, device, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device=device, dtype=dtype)


@pytest.mark.parametrize("name", LM_DTYPES)
@pytest.mark.parametrize("d", [199, 200, 1536, 2560, 6144])
def test_rmsnorm_kernel_matches_plain_version(cuda, name, d):
    """At 1, 8, 37 and 2048 rows within tolerance of the plain version,
    and a row gives the same bits at every row count (D 199 takes the
    scalar loads, 200 bf16 the 16-byte ones), and in a tensor that is not
    16-byte aligned (the scalar loads)."""
    dtype, tol = LM_DTYPES[name]
    x = _randn((2048, d), dtype, cuda, d) * 3
    scale = _randn((d,), torch.float32, cuda, d + 1)
    before = rms.rmsnorm.launches
    full = rms.rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert rms.rmsnorm.launches == before + 1
    assert full.dtype == dtype
    for rows in (1, 8, 37, 2048):
        got = rms.rmsnorm(x[:rows].contiguous(), scale)
        assert torch.equal(got, full[:rows])
        assert_allclose(got.float().cpu().numpy(),
                        ref.rmsnorm(x[:rows], scale).float().cpu().numpy(),
                        rtol=tol, atol=tol)
    odd = torch.empty(37 * d + 1, dtype=dtype, device=cuda)[1:].view(37, d)
    odd.copy_(x[:37])
    assert torch.equal(rms.rmsnorm(odd, scale), full[:37])


# gemma3-12b's head dim: 1 and 2 query heads per kv head, with and
# without a window, at lengths around the 64-row tile
FLASH_256 = [(1, S, S, 2 * G, 2, 256, window, 0) for S in (1, 63, 64, 65, 257,
                                                         2048)
             for G in (1, 2) for window in (None, 100)]
# the edges of the tensor-core path: every head dim at lengths around the
# 64-row tile, with 1, 3 or 4 query heads per kv head and a window on
# every other case
FLASH_EDGES = [(1, S, S, 2 * (1, 3, 4)[i % 3], 2, D,
                100 if i % 2 else None, 0)
               for i, (S, D) in enumerate((S, D) for S in (1, 63, 64, 65, 257,
                                                           2048)
                                          for D in (16, 32, 64, 80, 128))]


@pytest.mark.parametrize("name", LM_DTYPES)
@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,window,q_offset", [
    (1, 257, 257, 32, 8, 80, 4096, 0),    # the served heads, ragged prompt
    (2, 70, 70, 4, 2, 16, 32, 0),         # the smoke config's heads
    (1, 100, 100, 4, 1, 64, 33, 0),       # narrow band across tiles
    (1, 40, 130, 2, 2, 128, None, 0),     # suffix-aligned q
    (1, 30, 90, 4, 4, 32, 20, 50),        # explicit q_offset
    (2, 65, 300, 6, 2, 64, 129, 0),       # Sq < Sk, a window cutting the band
    (2, 65, 300, 6, 2, 80, 129, 100),
] + FLASH_EDGES + FLASH_256)
def test_flash_attention_kernel_matches_plain_version(
        cuda, name, B, Sq, Sk, H, KV, D, window, q_offset):
    dtype, tol = LM_DTYPES[name]
    q = _randn((B, Sq, H, D), dtype, cuda, 1)
    k = _randn((B, Sk, KV, D), dtype, cuda, 2)
    v = _randn((B, Sk, KV, D), dtype, cuda, 3)
    before = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=True, window=window,
                             q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == before + 1
    want = ref.attention(q, k, v, causal=True, window=window,
                         q_offset=q_offset)
    assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                    rtol=tol, atol=tol)
    got = fa.flash_attention(q, k, v, causal=False, window=window,
                             q_offset=q_offset)
    want = ref.attention(q, k, v, causal=False, window=window,
                         q_offset=q_offset)
    assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                    rtol=tol, atol=tol)


# llama4-maverick's 40/8 heads (G 5), 6 and 7 a kv head, and granite-20b's
# 48 on one kv head (three m16 tiles of one block), some rows masked by pos
DECODE_GROUPS = [(8, 4096, 40, 8, 128, [0, 1, 255, 256, 1000, 2047, 4095,
                                        9000]),
                 (3, 600, 12, 2, 64, [17, 599, 300]),
                 (3, 600, 14, 2, 80, [17, 599, 300]),
                 (8, 4096, 48, 1, 128, [0, 1, 255, 256, 1000, 2047, 4095,
                                        9000])]
DECODE_ROWS = [
    (8, 4096, 32, 8, 80, [0, 1, 255, 256, 1000, 2047, 4095, 9000]),
    (8, 4096, 24, 8, 64, [0, 1, 255, 256, 1000, 2047, 4095, 9000]),  # G = 3
    (3, 300, 4, 2, 16, [17, 299, 301]),
    (2, 64, 8, 8, 128, None),
] + DECODE_GROUPS


def _decode_inputs(B, S, H, KV, D, pos, dtype, device):
    q = _randn((B, H, D), dtype, device, 4)
    k = _randn((B, S, KV, D), dtype, device, 5)
    v = _randn((B, S, KV, D), dtype, device, 6)
    p = None if pos is None else torch.tensor(pos, dtype=torch.int32,
                                              device=device)
    return q, k, v, p


@pytest.mark.parametrize("name", LM_DTYPES)
@pytest.mark.parametrize("B,S,H,KV,D,pos", DECODE_ROWS)
def test_decode_attention_kernel_matches_plain_version(
        cuda, name, B, S, H, KV, D, pos):
    dtype, tol = LM_DTYPES[name]
    q, k, v, p = _decode_inputs(B, S, H, KV, D, pos, dtype, cuda)
    before = da.decode_attention.launches
    got = da.decode_attention(q, k, v, p)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    assert_allclose(got.float().cpu().numpy(),
                    ref.decode_attention(q, k, v, p).float().cpu().numpy(),
                    rtol=tol, atol=tol)
    # a head's result does not depend on its place in the group: rotate
    # each kv head's query heads by 3 and rotate back
    G = H // KV
    perm = torch.tensor([j * G + (g + 3) % G for j in range(KV)
                         for g in range(G)], device=cuda)
    back = torch.argsort(perm)
    again = da.decode_attention(q[:, perm].contiguous(), k, v, p)
    assert torch.equal(again[:, back], got)


@pytest.mark.parametrize("name", LM_DTYPES)
@pytest.mark.parametrize("B,S,H,KV,D,pos", DECODE_ROWS)
def test_decode_attention_slot_does_not_depend_on_the_batch(
        cuda, name, B, S, H, KV, D, pos):
    """Each slot of the batch, run alone as a batch of one, gives the same
    bits: the split size sees neither B nor pos, and a slot's splits
    merge in the same order whichever slots are beside it."""
    dtype, _ = LM_DTYPES[name]
    q, k, v, p = _decode_inputs(B, S, H, KV, D, pos, dtype, cuda)
    got = da.decode_attention(q, k, v, p)
    for b in range(B):
        alone = da.decode_attention(
            q[b:b + 1].clone(), k[b:b + 1].clone(), v[b:b + 1].clone(),
            None if p is None else p[b:b + 1].clone())
        assert torch.equal(alone, got[b:b + 1]), f"slot {b}"


@pytest.mark.parametrize("name", {"float32": 1e-4, "bfloat16": 5e-2})
@pytest.mark.parametrize("E,C,d,f", [
    (40, 8, 1536, 512), (40, 8, 512, 1536),      # a decode tick
    (40, 512, 1536, 512), (40, 512, 512, 1536),  # a 2048-token prefill
    (40, 275, 1536, 512), (40, 275, 512, 1536),  # a ragged capacity
    (3, 1, 40, 24),                              # K tail, ragged F
    (4, 70, 512, 520),                           # F 8 into a 128-wide tile
] + [(40, C, d, f) for C in (1, 63, 64, 65)      # around a warpgroup's rows
     for d, f in ((1536, 512), (512, 1536))] +
    # jamba-v0.1-52b: 16 experts, an 8-slot tick's and a 2048-token
    # prompt's capacity, the gate/up and the down products
    [(16, C, d, f) for C in (8, 320)
     for d, f in ((4096, 14336), (14336, 4096))])
def test_moe_gmm_kernel_matches_plain_version(cuda, name, E, C, d, f):
    dtype = LM_DTYPES[name][0]
    tol = 1e-4 if name == "float32" else 5e-2
    x = _randn((E, C, d), dtype, cuda, 7)
    w = (_randn((E, d, f), torch.float32, cuda, 8) / d ** 0.5).to(dtype)
    before = gmm.moe_gmm.launches
    got = gmm.moe_gmm(x, w)
    torch.cuda.synchronize()
    assert gmm.moe_gmm.launches == before + 1
    assert got.dtype == dtype and got.shape == (E, C, f)
    assert_allclose(got.float().cpu().numpy(),
                    ref.moe_gmm(x, w).float().cpu().numpy(),
                    rtol=tol, atol=tol)
    # a row's result depends on neither C nor the other rows
    head = gmm.moe_gmm(x[:, :1].contiguous(), w)
    assert torch.equal(head, got[:, :1])


@pytest.mark.parametrize("name,tag,n_bf16,opcode", [
    # the forward's product and the backward's two (dx <0, 0>, dw <1, 1>)
    ("moe_gmm", "gmm_wgmma", 3, "HGMMA"),
    ("flash_attention", "flash_fwd_wgmma", 6, "HGMMA"),
    # dQ and dK/dV at head dims 16, 32, 64, 80, 128 (256: CUDA cores)
    ("flash_attention_bwd", "_wgmma", 10, "HGMMA"),
    # decode: 6 head dims x 1-4 m16 tiles of query heads, mma.sync
    ("decode_attention", "decode_bf16", 24, "HMMA")])
def test_bf16_kernels_use_the_tensor_cores(cuda, name, tag, n_bf16, opcode):
    """The SASS of every bf16 kernel holds tensor-core instructions (HGMMA
    for wgmma, HMMA for mma.sync); the float32 kernels run on the CUDA
    cores and hold none of either."""
    counts = build.sass_counts(name, opcode)
    tc = {k: v for k, v in counts.items() if tag in k}
    assert len(tc) == n_bf16 and all(v > 0 for v in tc.values()), counts
    for op in ("HGMMA", "HMMA"):
        assert not any(v for k, v in build.sass_counts(name, op).items()
                       if tag not in k), op


def test_moe_gmm_rejects_what_it_does_not_take(cuda):
    x = torch.zeros(2, 8, 16, device=cuda)
    w = torch.zeros(2, 16, 16, device=cuda)
    with pytest.raises(TypeError):
        gmm.moe_gmm(x.half(), w.half())
    with pytest.raises(ValueError):
        gmm.moe_gmm(x, w.cpu())                          # mixed devices
    with pytest.raises(ValueError):
        gmm.moe_gmm(x, torch.zeros(2, 16, 12, device=cuda))  # f % 8
    with pytest.raises(ValueError):
        gmm.moe_gmm(x.transpose(0, 1).contiguous().transpose(0, 1), w)


def test_lm_kernels_reject_what_they_do_not_take(cuda):
    x = torch.zeros(4, 64, device=cuda)
    scale = torch.ones(64, device=cuda)
    with pytest.raises(TypeError):
        rms.rmsnorm(x.half(), scale)
    with pytest.raises(ValueError):
        rms.rmsnorm(x, scale.cpu())                     # mixed devices
    with pytest.raises(ValueError):
        rms.rmsnorm(x.t(), torch.ones(4, device=cuda))  # not contiguous
    q = torch.zeros(1, 8, 4, 16, device=cuda)
    with pytest.raises(TypeError):
        fa.flash_attention(q.half(), q.half(), q.half())
    with pytest.raises(ValueError):
        fa.flash_attention(q, q.cpu(), q)
    with pytest.raises(ValueError):
        fa.flash_attention(torch.zeros(1, 8, 4, 24, device=cuda),
                           torch.zeros(1, 8, 4, 24, device=cuda),
                           torch.zeros(1, 8, 4, 24, device=cuda))  # head dim
    cache = torch.zeros(1, 8, 2, 16, device=cuda)
    with pytest.raises(TypeError):
        da.decode_attention(q[:, 0], cache, cache,
                            torch.zeros(1, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError):
        da.decode_attention(q[:, 0], cache, cache,
                            torch.zeros(1, dtype=torch.int32))  # pos on cpu
    with pytest.raises(ValueError):
        da.decode_attention(q[:, 0, :3], cache, cache)   # 3 heads over 2


def test_engine_serves_through_the_kernels(cuda):
    """One request on the card launches every LM kernel: 2 norms per
    layer plus the final one per forward, one flash attention per layer
    in prefill and one decode attention per layer per tick."""
    cfg = get_smoke_config("h2o-danube-1.8b").scaled(remat=False)
    model = tf.init_model(cfg, torch.Generator().manual_seed(0))
    assert model.device.type == "cuda"
    eng = ServeEngine(model, slots=2, cache_len=64)
    counts = (rms.rmsnorm.launches, fa.flash_attention.launches,
              da.decode_attention.launches)
    rid = eng.submit(np.arange(40) % cfg.vocab_size, max_new=4)
    out = eng.run()[rid]
    assert len(out) == 4
    L = cfg.num_layers
    assert rms.rmsnorm.launches - counts[0] == (2 * L + 1) * 4
    assert fa.flash_attention.launches - counts[1] == L
    assert da.decode_attention.launches - counts[2] == L * 3
    cpu = tf.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng_cpu = ServeEngine(cpu, slots=2, cache_len=64, device="cpu")
    rid = eng_cpu.submit(np.arange(40) % cfg.vocab_size, max_new=4)
    assert eng_cpu.run()[rid] == out


def test_engine_serves_granite_through_the_kernels(cuda):
    """granite-moe-3b-a800m's smoke config on the card: each forward
    makes three grouped expert products per layer through the kernel,
    and the greedy tokens are the CPU plain path's."""
    cfg = get_smoke_config("granite-moe-3b-a800m").scaled(remat=False)
    model = tf.init_model(cfg, torch.Generator().manual_seed(0))
    eng = ServeEngine(model, slots=2, cache_len=64)
    counts = (gmm.moe_gmm.launches, fa.flash_attention.launches,
              da.decode_attention.launches)
    rid = eng.submit(np.arange(40) % cfg.vocab_size, max_new=4)
    out = eng.run()[rid]
    assert len(out) == 4
    L = cfg.num_layers
    assert gmm.moe_gmm.launches - counts[0] == 3 * L * 4
    assert fa.flash_attention.launches - counts[1] == L
    assert da.decode_attention.launches - counts[2] == L * 3
    cpu = tf.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng_cpu = ServeEngine(cpu, slots=2, cache_len=64, device="cpu")
    rid = eng_cpu.submit(np.arange(40) % cfg.vocab_size, max_new=4)
    assert eng_cpu.run()[rid] == out
    # the MoE layer never waits for the card: every shape follows from T
    x = torch.randn(2, 9, cfg.d_model, device=cuda)
    torch.cuda.set_sync_debug_mode("error")
    try:
        model.blocks[0].ffn(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_fleet_equals_standalone_on_the_card(cuda):
    """tests/test_fleet.py's 8-query workload at 0.1 h on the card: the
    uncontended fleet's Progress of every query is its standalone run's,
    bit for bit, with fewer dispatches, stacked superbatches through the
    grouped kernels, and no retrace."""
    from repro_torch.core import landmarks as lm_mod
    from repro_torch.core.fleet import FleetScheduler, make_executor
    from repro_torch.core.hardware import YOLO_V3
    from repro_torch.core.query import Query, make_env
    from repro_torch.core.training import FrameBank
    from repro_torch.core.video import QUERY_CLASS, Video, corpus
    specs = [("JacksonH", "retrieval", {"max_passes": 2}),
             ("Banff", "retrieval", {"max_passes": 2}),
             ("JacksonH", "count_max", {"max_passes": 2}),
             ("Miami", "count_max", {"max_passes": 2}),
             ("Banff", "tagging", {}), ("Miami", "tagging", {}),
             ("Banff", "count_avg", {}), ("Miami", "count_median", {})]
    videos = {n: Video(corpus(hours=0.1)[n])
              for n in ("JacksonH", "Banff", "Miami")}
    stores = {n: lm_mod.build_landmarks(v, 30, YOLO_V3)
              for n, v in videos.items()}
    banks = {n: FrameBank(v) for n, v in videos.items()}

    def executor(cam, kind):
        env = make_env(videos[cam], Query(kind, QUERY_CLASS[cam]),
                       stores[cam], bank=banks[cam], train_steps=5)
        ex = make_executor(env, full_family=False)
        if kind == "tagging":
            ex.levels = (30, 10, 1)
        return ex

    solo, solo_calls = [], 0
    for cam, kind, kw in specs:
        rt = rt_mod.OperatorRuntime()
        prev = rt_mod.set_runtime(rt)
        try:
            solo.append(executor(cam, kind).run(**kw))
        finally:
            rt_mod.set_runtime(prev)
        solo_calls += rt.calls
    rt = rt_mod.OperatorRuntime()
    prev = rt_mod.set_runtime(rt)
    grouped = cs.conv_scorer.grouped_launches
    try:
        sched = FleetScheduler(contended=False)
        for i, (cam, kind, kw) in enumerate(specs):
            sched.add(f"q{i}", cam, executor(cam, kind), **kw)
        with rt_mod.TraceGuard(rt):
            fleet = sched.run()
    finally:
        rt_mod.set_runtime(prev)
    for i, mine in enumerate(solo):
        got = fleet[f"q{i}"]
        assert (got.points, got.bytes_up, got.done_t, got.op_switches) == \
            (mine.points, mine.bytes_up, mine.done_t, mine.op_switches), i
    assert sched.stats["dispatches"] < solo_calls
    assert rt.super_calls > 0
    assert cs.conv_scorer.grouped_launches > grouped


# -- the recurrent blocks -----------------------------------------------------

@pytest.mark.parametrize("mixer,d,L", [("mamba", 256, 1024),
                                       ("mlstm", 256, 512),
                                       ("slstm", 256, 64)])
def test_recurrent_block_on_the_card_matches_the_cpu(cuda, mixer, d, L):
    """A Mamba (two 512-token chunks), mLSTM (two 256-token chunks) and
    sLSTM block, float32, the same weights on the card and on the CPU:
    the prefill's output and cache, then four decode steps, within 1e-4
    (cuBLAS and the host's BLAS sum in other orders)."""
    cfg = get_smoke_config("xlstm-125m" if mixer != "mamba" else
                           "jamba-v0.1-52b").scaled(d_model=d, num_heads=4)
    w = tf._draw_mixer(cfg, mixer, torch.Generator().manual_seed(0))
    cpu = tf.recurrent_mixer(cfg, mixer, w)
    card = tf.recurrent_mixer(cfg, mixer, w).to(cuda)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, L, d)).astype(np.float32))

    def close(a, b):
        for u, v in zip(_leaves(a), _leaves(b)):
            assert_allclose(u.cpu().numpy(), v.numpy(), rtol=1e-4, atol=1e-4)

    got, cache = card(x.to(cuda))
    want, want_cache = cpu(x)
    close(got, want)
    close(cache, want_cache)
    for t in range(4):
        xt = torch.from_numpy(rng.standard_normal((2, 1, d)).astype(
            np.float32))
        got, cache = card.decode(xt.to(cuda), cache)
        want, want_cache = cpu.decode(xt, want_cache)
        close(got, want)
        close(cache, want_cache)


def _leaves(tree):
    """The tensors of a tensor, tuple or cache dict, in a fixed order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [t for x in tree for t in _leaves(x)]
    return [tree]


@pytest.mark.parametrize("arch", ["jamba-v0.1-52b", "xlstm-125m"])
def test_engine_splices_the_recurrent_state_on_the_card(cuda, arch):
    """On the card, a reused slot's every cache leaf after prefill is the
    request's own prefill alone (a conv tail under 3 rows padded at the
    end, F6), and the greedy tokens are the CPU plain path's; jamba's
    forwards run rmsnorm, flash and decode attention and moe_gmm."""
    cfg = get_smoke_config(arch).scaled(remat=False)
    model = tf.init_model(cfg, torch.Generator().manual_seed(0))
    counts = (rms.rmsnorm.launches, gmm.moe_gmm.launches)
    prompts = [(np.arange(9) % cfg.vocab_size, 3),
               (np.arange(4) % cfg.vocab_size, 1), (np.array([3, 1]), 4)]
    eng = ServeEngine(model, slots=2, cache_len=64)
    for p, n in prompts:
        eng.submit(p, n)
    eng._admit({})
    eng._tick({})
    eng._admit({})                  # the 2-token prompt takes slot 1
    _, alone = tf.prefill(model, torch.tensor([[3, 1]], device=cuda))
    for c, a in zip(eng.caches, alone):
        for got, want in zip(_leaves(c), _leaves(a)):
            n = want.shape[1]
            assert torch.equal(got[1, :n], want[0])
            assert not got[1, n:].any()
    eng.run()
    cpu = tf.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    eng_cpu = ServeEngine(cpu, slots=2, cache_len=64, device="cpu")
    for p, n in prompts:
        eng_cpu.submit(p, n)
    eng_cpu.run()
    assert {r: q.out for r, q in eng.requests.items()} == \
        {r: q.out for r, q in eng_cpu.requests.items()}
    assert rms.rmsnorm.launches > counts[0]
    assert (gmm.moe_gmm.launches > counts[1]) == (cfg.num_experts > 0)


# -- training: the backward kernels -------------------------------------------

BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # relative to the largest


def _close(got, want, tol, what):
    got, want = got.float().cpu(), want.float().cpu()
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max()) / scale
    assert err <= tol, f"{what}: {err}"


# (rows, D): vector and scalar (D 199, 8191) paths, one row slot a block
# (D 8192) and eight (D 64, 199, 200, 768), 1 and 3 rows and fewer row
# groups than the grid (100 rows), the zoo's widths at its training rows
RMS_BWD = [(1, 64), (37, 199), (300, 200), (4096, 1536), (2048, 2560),
           (8, 6144), (1, 1536), (3, 1536), (3, 768), (100, 1536),
           (4096, 768), (512, 4096), (5, 8191), (64, 8192), (4096, 8192)]


@pytest.mark.parametrize("name", BWD_TOL)
@pytest.mark.parametrize("rows,d", RMS_BWD)
def test_rmsnorm_bwd_kernel_matches_plain_version(cuda, name, rows, d):
    """dx and dscale within tolerance of ``ref.rmsnorm_bwd``, and a second
    launch gives the same bits (dscale's partial rows are added in a fixed
    order; no atomics)."""
    dtype = LM_DTYPES[name][0]
    x = _randn((rows, d), dtype, cuda, d) * 3
    scale = 1 + 0.1 * _randn((d,), torch.float32, cuda, d + 1)
    dy = _randn((rows, d), dtype, cuda, d + 2)
    before = rms.rmsnorm_bwd.launches
    dx, ds = rms.rmsnorm_bwd(x, scale, dy)
    torch.cuda.synchronize()
    assert rms.rmsnorm_bwd.launches == before + 1
    assert dx.dtype == dtype and ds.dtype == torch.float32
    want = ref.rmsnorm_bwd(x, scale, dy)
    _close(dx, want[0], BWD_TOL[name], "dx")
    _close(ds, want[1], BWD_TOL[name], "dscale")
    dx2, ds2 = rms.rmsnorm_bwd(x, scale, dy)
    assert torch.equal(dx, dx2) and torch.equal(ds, ds2)


@pytest.mark.parametrize("name", BWD_TOL)
@pytest.mark.parametrize("rows,d", [(1, 64), (37, 199), (4096, 768),
                                    (4096, 1536), (64, 4096), (5, 8191),
                                    (64, 8192)])
def test_rmsnorm_bwd_is_one_launch(cuda, name, rows, d):
    """One call, captured into a CUDA graph, is one kernel node (the
    cooperative launch) and nothing else: no second kernel, memset or
    copy."""
    dtype = LM_DTYPES[name][0]
    x = _randn((rows, d), dtype, cuda, 1)
    scale = 1 + 0.1 * _randn((d,), torch.float32, cuda, 2)
    dy = _randn((rows, d), dtype, cuda, 3)
    rms.rmsnorm_bwd(x, scale, dy)            # builds the kernel uncaptured
    names = build.graph_kernels(lambda: rms.rmsnorm_bwd(x, scale, dy))
    assert len(names) == 1 and "rmsnorm_bwd_kernel" in names[0], names


@pytest.mark.parametrize("name", BWD_TOL)
@pytest.mark.parametrize("d", [1536, 8191])
def test_rmsnorm_bwd_takes_misaligned_views(cuda, name, d):
    """x and dy as views that start 1 and 3 elements into their storage
    (not 16-byte aligned): within tolerance of the plain version, and dx
    bit for bit the aligned copies' (the same per-row arithmetic)."""
    dtype = LM_DTYPES[name][0]
    rows = 33
    bx = _randn((rows * d + 1,), dtype, cuda, 4) * 3
    bd = _randn((rows * d + 3,), dtype, cuda, 5)
    x, dy = bx[1:].view(rows, d), bd[3:].view(rows, d)
    assert x.data_ptr() % 16 and dy.data_ptr() % 16
    scale = 1 + 0.1 * _randn((d,), torch.float32, cuda, 6)
    dx, ds = rms.rmsnorm_bwd(x, scale, dy)
    want = ref.rmsnorm_bwd(x, scale, dy)
    _close(dx, want[0], BWD_TOL[name], "dx")
    _close(ds, want[1], BWD_TOL[name], "dscale")
    ax, ads = rms.rmsnorm_bwd(x.clone(), scale, dy.clone())
    assert torch.equal(dx, ax)
    _close(ds, ads, BWD_TOL[name], "dscale against the aligned copies")


@pytest.mark.parametrize("name", BWD_TOL)
@pytest.mark.parametrize("d", [768, 1536, 8192])
def test_rmsnorm_bwd_row_bits_follow_no_row_count(cuda, name, d):
    """A row's dx has the same bits alone (1 row), among 3 and among
    4096: its sums and arithmetic depend on D only."""
    dtype = LM_DTYPES[name][0]
    x = _randn((4096, d), dtype, cuda, 7) * 3
    scale = 1 + 0.1 * _randn((d,), torch.float32, cuda, 8)
    dy = _randn((4096, d), dtype, cuda, 9)
    full, _ = rms.rmsnorm_bwd(x, scale, dy)
    for i in (0, 1, 1000, 4095):
        alone, _ = rms.rmsnorm_bwd(x[i:i + 1], scale, dy[i:i + 1])
        assert torch.equal(alone, full[i:i + 1]), i
    three, _ = rms.rmsnorm_bwd(x[5:8], scale, dy[5:8])
    assert torch.equal(three, full[5:8])


@pytest.mark.parametrize("name", BWD_TOL)
def test_rmsnorm_bwd_bits_repeat_beside_another_stream(cuda, name):
    """dx and dscale at granite's training shape have the same bits after,
    and while, other kernels run on another stream (matmuls, forward norms
    of another shape): the grid and the summation order do not follow what
    else the card runs."""
    dtype = LM_DTYPES[name][0]
    x = _randn((4096, 1536), dtype, cuda, 10) * 3
    scale = 1 + 0.1 * _randn((1536,), torch.float32, cuda, 11)
    dy = _randn((4096, 1536), dtype, cuda, 12)
    first = rms.rmsnorm_bwd(x, scale, dy)
    torch.cuda.synchronize()
    other = torch.cuda.Stream()
    a = _randn((2048, 2048), dtype, cuda, 13)
    ox = _randn((1000, 2560), dtype, cuda, 14)
    oscale = torch.ones(2560, device=cuda)
    with torch.cuda.stream(other):
        for _ in range(20):
            a = (a @ a) / 2048 ** 0.5
            rms.rmsnorm(ox, oscale)
    seen = [rms.rmsnorm_bwd(x, scale, dy) for _ in range(5)]
    torch.cuda.synchronize()
    for got in seen:
        assert torch.equal(got[0], first[0]) and torch.equal(got[1],
                                                             first[1])


# (B, Sq, Sk, H, KV, D, window, q_offset): groups of 1, 2, 3 and 4,
# windows whose edge falls inside a tile, q_offset and suffix-aligned q,
# lengths that are not multiples of the 64-row tiles, B 2, every head dim
# around the tiles (16-128 on the bf16 tensor-core kernels, 256 on the
# CUDA-core ones)
FLASH_BWD = [
    (2, 70, 70, 4, 2, 16, 32, 0),
    (1, 100, 100, 3, 1, 64, 33, 0),
    (1, 40, 130, 2, 2, 128, None, 0),
    (1, 30, 90, 4, 4, 32, 20, 50),
    (2, 65, 300, 6, 2, 80, 129, 100),
    (1, 257, 257, 6, 2, 256, None, 0),
    (1, 129, 129, 2, 1, 256, 100, 0),
    (1, 77, 141, 8, 2, 64, None, 60),         # ragged q and k, q_offset
    (2, 190, 190, 4, 4, 64, 70, 0),           # group 1, window edge in a tile
    (1, 150, 150, 8, 2, 128, 90, 0),          # group 4 at D 128
    (1, 257, 257, 4, 1, 80, None, 0),         # D 80 at S 257, group 4
    (2, 200, 333, 6, 2, 32, 100, 133),        # B 2, window and q_offset
    (4, 1024, 1024, 24, 8, 64, None, 0),      # granite's training shape
    (1, 4096, 4096, 32, 8, 80, 4096, 0),      # h2o's, one row
]


@pytest.mark.parametrize("name", BWD_TOL)
@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,window,q_offset", FLASH_BWD)
def test_flash_attention_bwd_kernel_matches_plain_version(
        cuda, name, B, Sq, Sk, H, KV, D, window, q_offset):
    """The forward's log-sum-exp against the plain scores', then dq, dk,
    dv within tolerance of ``ref.attention_bwd``, and a second launch
    gives the same bits (a group's heads summed in one block)."""
    dtype = LM_DTYPES[name][0]
    q = _randn((B, Sq, H, D), dtype, cuda, 1)
    k = _randn((B, Sk, KV, D), dtype, cuda, 2)
    v = _randn((B, Sk, KV, D), dtype, cuda, 3)
    dout = _randn((B, Sq, H, D), dtype, cuda, 4)
    out, lse = fa._forward(q, k, v, True, window, q_offset, True)
    keep = ref.keep_mask(Sq, Sk, True, window, q_offset, cuda)
    s = torch.einsum("bqhd,bshd->bhqs", q.float(),
                     ref.expand_kv(k, H).float()) / D ** 0.5
    want_lse = torch.logsumexp(s.masked_fill(~keep, -float("inf")), -1)
    _close(lse, want_lse, 1e-5, "lse")
    before = fa.flash_attention_bwd.launches
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=True,
                                 window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert fa.flash_attention_bwd.launches == before + 1
    want = ref.attention_bwd(q, k, v, out, dout, causal=True, window=window,
                             q_offset=q_offset)
    for g, w, n in zip(got, want, ("dq", "dk", "dv")):
        assert g.dtype == dtype and g.shape == w.shape
        _close(g, w, BWD_TOL[name], n)
    again = fa.flash_attention_bwd(q, k, v, out, lse, dout, causal=True,
                                   window=window, q_offset=q_offset)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("B,S,H,KV,D,window", [
    (2, 300, 24, 8, 64, None), (3, 257, 32, 8, 80, 100),
    (2, 130, 4, 4, 128, None)])
def test_flash_attention_bwd_bits_do_not_depend_on_the_batch(
        cuda, B, S, H, KV, D, window):
    """In bf16 each row of a batch gets the bits it gets alone: dq, dk and
    dv of batch row i (a kv head's group summed in one block) equal those
    of a batch of 1 made of that row."""
    dtype = torch.bfloat16
    q = _randn((B, S, H, D), dtype, cuda, 1)
    k = _randn((B, S, KV, D), dtype, cuda, 2)
    v = _randn((B, S, KV, D), dtype, cuda, 3)
    dout = _randn((B, S, H, D), dtype, cuda, 4)
    out, lse = fa._forward(q, k, v, True, window, 0, True)
    got = fa.flash_attention_bwd(q, k, v, out, lse, dout, window=window)
    for i in range(B):
        one = [t[i:i + 1].contiguous() for t in (q, k, v, out, lse, dout)]
        alone = fa.flash_attention_bwd(*one, window=window)
        for g, a, n in zip(got, alone, ("dq", "dk", "dv")):
            assert torch.equal(g[i:i + 1], a), f"{n} of batch row {i}"


@pytest.mark.parametrize("name", BWD_TOL)
@pytest.mark.parametrize("E,C,d,f", [(40, 1024, 1536, 512),
                                     (40, 1024, 512, 1536),
                                     (40, 275, 1536, 512), (3, 13, 40, 24),
                                     (8, 1, 64, 32)])
def test_moe_gmm_bwd_matches_plain_version(cuda, name, E, C, d, f):
    """dx and dw (the kernel reading x, w and dy in place, C of any size)
    within tolerance of ``ref.moe_gmm_bwd``; the same bits again."""
    dtype = LM_DTYPES[name][0]
    x = _randn((E, C, d), dtype, cuda, 7)
    w = (_randn((E, d, f), torch.float32, cuda, 8) / d ** 0.5).to(dtype)
    dy = _randn((E, C, f), dtype, cuda, 9)
    before = gmm.moe_gmm_bwd.launches
    dx, dw = gmm.moe_gmm_bwd(x, w, dy)
    torch.cuda.synchronize()
    assert gmm.moe_gmm_bwd.launches == before + 2
    want = ref.moe_gmm_bwd(x, w, dy)
    _close(dx, want[0], BWD_TOL[name], "dx")
    _close(dw, want[1], BWD_TOL[name], "dw")
    dx2, dw2 = gmm.moe_gmm_bwd(x, w, dy)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


def _gmm_bwd_on_copies(x, w, dy):
    """dx and dw by the forward kernel on explicit transposed copies, C
    padded with zero rows to a multiple of 8 for dw: the backward before
    it read its operands in place."""
    pad = -x.shape[1] % 8
    xt = torch.nn.functional.pad(x, (0, 0, 0, pad)).transpose(1, 2)
    return (gmm._product(dy, w.transpose(1, 2).contiguous()),
            gmm._product(xt.contiguous(),
                         torch.nn.functional.pad(dy, (0, 0, 0, pad))))


@pytest.mark.parametrize("name", BWD_TOL)
@pytest.mark.parametrize("E,C,d,f", [(40, 1024, 1536, 512),
                                     (40, 1024, 512, 1536),
                                     (40, 275, 1536, 512), (3, 13, 40, 24),
                                     (8, 1, 64, 32), (2, 200, 136, 264)])
def test_moe_gmm_bwd_reads_in_place(cuda, name, E, C, d, f):
    """The backward launches its two GEMM kernels and nothing else (no
    copy, pad or transpose kernel: the nodes of one call captured into a
    CUDA graph), and its dx
    and dw equal, bit for bit, the forward kernel's on explicit transposed
    and padded copies: the same sums over K in the same order."""
    dtype = LM_DTYPES[name][0]
    tag = "gmm_wgmma" if dtype == torch.bfloat16 else "gmm_tile"
    x = _randn((E, C, d), dtype, cuda, 7)
    w = (_randn((E, d, f), torch.float32, cuda, 8) / d ** 0.5).to(dtype)
    dy = _randn((E, C, f), dtype, cuda, 9)
    dx, dw = gmm.moe_gmm_bwd(x, w, dy)   # builds the kernel uncaptured
    names = build.graph_kernels(lambda: gmm.moe_gmm_bwd(x, w, dy))
    assert len(names) == 2 and all(tag in n for n in names), names
    cx, cw = _gmm_bwd_on_copies(x, w, dy)
    assert torch.equal(dx, cx) and torch.equal(dw, cw)


def test_training_step_bits_do_not_follow_history(cuda):
    """Three AdamW steps of granite-moe-3b-a800m's smoke config in bf16
    compute, as ``launch.train`` takes them (the forward and backward
    kernels, the MoE dispatch, the chunked cross-entropy, remat, AdamW),
    give every loss, gradient norm and parameter the same bits fresh and
    after other work in the same process: allocations of odd sizes kept
    across them, matmuls of other shapes, a step at another batch."""
    from repro_torch.train import data as data_mod
    from repro_torch.train import optimizer as opt
    cfg = get_smoke_config("granite-moe-3b-a800m")

    def run(n_steps=3, batch=2, seq=128):
        model = tf.init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                              cuda, trainable=True)
        ostate = opt.init_opt_state(dict(model.named_parameters()))
        pipe = data_mod.TokenPipeline(data_mod.DataConfig(
            vocab_size=cfg.vocab_size, batch=batch, seq_len=seq))
        step = steps.make_train_step(cfg, opt.AdamWConfig(
            total_steps=n_steps))
        seen = []
        with steps.deterministic():
            for i in range(n_steps):
                model, ostate, m = step(model, ostate, pipe.batch_at(i))
                seen.append((float(m["loss"]), float(m["grad_norm"])))
        return seen, {n: p.detach().clone()
                      for n, p in model.named_parameters()}

    fresh = run()
    rng = np.random.default_rng(0)
    kept = [torch.empty(int(n), dtype=torch.uint8, device=cuda)
            for n in rng.integers(1, 5_000_000, 40)][::2]
    a = _randn((37, 333), torch.bfloat16, cuda, 5)
    (a @ a.T).sum().item()
    run(n_steps=1, batch=1, seq=64)
    later = run()
    kept.clear()   # the held allocations are let go
    assert fresh[0] == later[0]
    assert all(torch.equal(fresh[1][n], later[1][n]) for n in fresh[1]), \
        [n for n in fresh[1] if not torch.equal(fresh[1][n], later[1][n])]


def _grads_of(fn, inputs):
    ins = [t.detach().clone().requires_grad_(True) for t in inputs]
    out = fn(*ins)
    g = torch.ones_like(out) if out.dim() == 0 else \
        _randn(out.shape, out.dtype, out.device, 11)
    out.backward(g)
    return out.detach(), [t.grad for t in ins]


@pytest.mark.parametrize("name", BWD_TOL)
def test_autograd_functions_match_the_plain_path(cuda, name):
    """``RMSNormFn``, ``FlashAttentionFn`` and ``MoeGmmFn`` on the card:
    output and every input's gradient against autograd of the plain
    forward (a gradcheck against the plain path, not finite
    differences)."""
    dtype = LM_DTYPES[name][0]
    tol = BWD_TOL[name]
    x = _randn((64, 256), dtype, cuda, 1)
    scale = 1 + 0.1 * _randn((256,), torch.float32, cuda, 2)
    cases = [(lambda a, s: rms.rmsnorm(a, s), lambda a, s: ref.rmsnorm(a, s),
              (x, scale))]
    q = _randn((2, 100, 6, 64), dtype, cuda, 3)
    k = _randn((2, 100, 2, 64), dtype, cuda, 4)
    v = _randn((2, 100, 2, 64), dtype, cuda, 5)
    cases.append((lambda a, b, c: fa.flash_attention(a, b, c, window=40),
                  lambda a, b, c: ref.attention(a, b, c, window=40),
                  (q, k, v)))
    xe = _randn((4, 21, 64), dtype, cuda, 6)
    we = (_randn((4, 64, 32), torch.float32, cuda, 7) / 8).to(dtype)
    cases.append((gmm.moe_gmm, ref.moe_gmm, (xe, we)))
    for kernel, plain, ins in cases:
        out_k, g_k = _grads_of(kernel, ins)
        out_p, g_p = _grads_of(plain, ins)
        _close(out_k, out_p, tol, "out")
        for a, b in zip(g_k, g_p):
            _close(a, b, tol, "grad")


def test_training_steps_on_the_card(cuda, tmp_path):
    """Two steps of granite-moe-3b-a800m's smoke config through the
    launcher on the card: finite losses, and every kernel of the path
    launched forward and backward."""
    from repro_torch.launch import train as launch_train
    counts = (rms.rmsnorm_bwd.launches, fa.flash_attention_bwd.launches,
              gmm.moe_gmm_bwd.launches)
    out = launch_train.run(["--arch", "granite-moe-3b-a800m", "--smoke",
                            "--steps", "2", "--batch", "2", "--seq", "64",
                            "--ckpt", str(tmp_path)])
    assert out["steps"] == 2 and all(np.isfinite(out["losses"]))
    L = get_smoke_config("granite-moe-3b-a800m").num_layers
    assert rms.rmsnorm_bwd.launches - counts[0] == 2 * (2 * L + 1)
    assert fa.flash_attention_bwd.launches - counts[1] == 2 * L
    assert gmm.moe_gmm_bwd.launches - counts[2] == 2 * 3 * L * 2


def test_superbatch_split_over_one_card_twice(cuda):
    """A superbatch of 4 members split over the scoring mesh
    ``["cuda:0", "cuda:0"]`` (two members a slot, each slot one grouped
    launch a layer) gives every member the unsplit superbatch's bits."""
    from repro_torch.launch.mesh import make_scoring_mesh
    sig = (3, 16, 32, 50)
    arch = ops.OperatorArch("split", *sig)
    params = [ops.init_operator(arch, torch.Generator().manual_seed(g))
              for g in range(4)]
    x = np.random.default_rng(4).uniform(
        size=(4, 256, 50, 50, 3)).astype(np.float32)
    whole = rt_mod.OperatorRuntime()
    wp, wc = whole._dispatch(sig, params, x, kind="super")
    split = rt_mod.OperatorRuntime(
        mesh=make_scoring_mesh(["cuda:0", "cuda:0"]))
    before = cs.conv_scorer.grouped_launches
    parts = split._launch(sig, params, x, kind="super")
    torch.cuda.synchronize()
    assert len(parts) == 2 and split.slot_parts["super"] == [1, 1]
    assert cs.conv_scorer.grouped_launches - before == 2 * sig[0]
    assert split.sharding_fallbacks() == []
    gp = torch.cat([p for p, _ in parts])
    gc = torch.cat([c for _, c in parts])
    assert torch.equal(gp, wp) and torch.equal(gc, wc)


def test_one_rank_distributed_step_is_the_plain_step(cuda, tmp_path):
    """Three AdamW steps of granite-moe-3b-a800m's smoke config through a
    1-rank gloo group (the data-parallel path: the router statistics and
    the loss gathered, the gradients all-gathered and summed) give every
    loss and parameter the plain trainer's bits."""
    import torch.distributed as dist
    from datetime import timedelta

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train import data as data_mod
    from repro_torch.train import optimizer as opt
    cfg = get_smoke_config("granite-moe-3b-a800m")

    def run(mesh):
        model = tf.init_model(cfg, torch.Generator(device=cuda).manual_seed(0),
                              cuda, trainable=True)
        ostate = opt.init_opt_state(dict(model.named_parameters()))
        pipe = data_mod.TokenPipeline(data_mod.DataConfig(
            vocab_size=cfg.vocab_size, batch=2, seq_len=128))
        step = steps.make_train_step(cfg, opt.AdamWConfig(total_steps=3),
                                     mesh)
        losses = []
        with steps.deterministic():
            for i in range(3):
                model, ostate, m = step(model, ostate, pipe.batch_at(i))
                losses.append(m["loss"])
        return losses, {n: p.detach().clone()
                        for n, p in model.named_parameters()}

    plain = run(None)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    try:
        mesh = make_local_mesh(cuda)
        assert mesh.group is not None and mesh.processes == 1
        one = run(mesh)
    finally:
        dist.destroy_process_group()
    assert all(torch.equal(a, b) for a, b in zip(plain[0], one[0]))
    assert all(torch.equal(plain[1][n], one[1][n]) for n in plain[1])


@pytest.mark.parametrize("arch,shape", [
    ("h2o-danube-1.8b", "prefill_32k"), ("h2o-danube-1.8b", "decode_32k"),
    ("granite-moe-3b-a800m", "train_4k"), ("granite-moe-3b-a800m",
                                           "decode_32k"),
    ("jamba-v0.1-52b", "train_4k"), ("xlstm-125m", "prefill_32k")])
def test_execute_cell_counts_what_meta_counts(cuda, arch, shape):
    """A narrow (smoke-width) 2-period cut of a cell, run on the card
    under the op count, counts exactly what the same cut counts on
    ``meta``: FLOPs, bytes, every kernel's calls and every aten op's."""
    from repro_torch.launch import dryrun
    cfg = get_smoke_config(arch)
    cfg = cfg.scaled(num_layers=min(cfg.num_layers, 2 * len(cfg.pattern)))
    r = dryrun.execute_cell(arch, shape, cuda, cfg=cfg, batch=2, seq=64)
    assert r["count_equal"], r["count_diff"]
    assert r["flops"] == r["meta_flops"] and r["bytes"] == r["meta_bytes"]
    assert r["kernels"] and 0 < r["roofline_share"] <= 1.0
