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
from repro_torch.kernels import conv_scorer as cs, ref  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import moe_gmm as gmm  # noqa: E402
from repro_torch.kernels import rmsnorm as rms  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.serving.engine import ServeEngine  # noqa: E402

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
    """Within 1e-4 of the plain version (cuDNN in full float32), and each
    output independent of N: a prefix of the batch gives the same bits."""
    h, cin, cout = FAMILY_LAYERS[i]
    x, w, b = _inputs(37, h, cin, cout, seed=i, device=cuda)
    before = cs.conv_scorer.launches
    got = cs.conv_scorer(x, w, b)
    torch.cuda.synchronize()
    assert cs.conv_scorer.launches == before + 1
    assert_allclose(got.cpu().numpy(), ref.conv_scorer(x, w, b).cpu().numpy(),
                    rtol=1e-4, atol=1e-4)
    assert torch.equal(cs.conv_scorer(x[:5].contiguous(), w, b), got[:5])


def test_kernel_rejects_what_it_does_not_take(cuda):
    x, w, b = _inputs(4, 25, 3, 8, seed=0, device=cuda)
    with pytest.raises(ValueError):
        cs.conv_scorer(x.permute(0, 2, 1, 3), w, b)     # not contiguous
    with pytest.raises(ValueError):
        cs.conv_scorer(x, w.cpu(), b)                    # mixed devices
    with pytest.raises(TypeError):
        cs.conv_scorer(x.half(), w, b)


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
@pytest.mark.parametrize("rows,d", [(1, 2560), (37, 2560), (5, 200)])
def test_rmsnorm_kernel_matches_plain_version(cuda, name, rows, d):
    dtype, tol = LM_DTYPES[name]
    x = _randn((rows, d), dtype, cuda, rows) * 3
    scale = _randn((d,), torch.float32, cuda, 1)
    before = rms.rmsnorm.launches
    got = rms.rmsnorm(x, scale)
    torch.cuda.synchronize()
    assert rms.rmsnorm.launches == before + 1
    assert got.dtype == dtype
    assert_allclose(got.float().cpu().numpy(),
                    ref.rmsnorm(x, scale).float().cpu().numpy(),
                    rtol=tol, atol=tol)


@pytest.mark.parametrize("name", LM_DTYPES)
@pytest.mark.parametrize("B,Sq,Sk,H,KV,D,window,q_offset", [
    (1, 257, 257, 32, 8, 80, 4096, 0),    # the served heads, ragged prompt
    (2, 70, 70, 4, 2, 16, 32, 0),         # the smoke config's heads
    (1, 100, 100, 4, 1, 64, 33, 0),       # narrow band across tiles
    (1, 40, 130, 2, 2, 128, None, 0),     # suffix-aligned q
    (1, 30, 90, 4, 4, 32, 20, 50),        # explicit q_offset
])
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


@pytest.mark.parametrize("name", LM_DTYPES)
@pytest.mark.parametrize("B,S,H,KV,D,pos", [
    (8, 4096, 32, 8, 80, [0, 1, 255, 256, 1000, 2047, 4095, 9000]),
    (8, 4096, 24, 8, 64, [0, 1, 255, 256, 1000, 2047, 4095, 9000]),  # G = 3
    (3, 300, 4, 2, 16, [17, 299, 301]),
    (2, 64, 8, 8, 128, None),
])
def test_decode_attention_kernel_matches_plain_version(
        cuda, name, B, S, H, KV, D, pos):
    dtype, tol = LM_DTYPES[name]
    q = _randn((B, H, D), dtype, cuda, 4)
    k = _randn((B, S, KV, D), dtype, cuda, 5)
    v = _randn((B, S, KV, D), dtype, cuda, 6)
    p = None if pos is None else torch.tensor(pos, dtype=torch.int32,
                                              device=cuda)
    before = da.decode_attention.launches
    got = da.decode_attention(q, k, v, p)
    torch.cuda.synchronize()
    assert da.decode_attention.launches == before + 1
    assert_allclose(got.float().cpu().numpy(),
                    ref.decode_attention(q, k, v, p).float().cpu().numpy(),
                    rtol=tol, atol=tol)


@pytest.mark.parametrize("name", {"float32": 1e-4, "bfloat16": 5e-2})
@pytest.mark.parametrize("E,C,d,f", [
    (40, 8, 1536, 512), (40, 8, 512, 1536),      # a decode tick
    (40, 512, 1536, 512), (40, 512, 512, 1536),  # a 2048-token prefill
    (40, 275, 1536, 512),                        # a ragged capacity
    (3, 1, 40, 24),                              # K tail, ragged F
])
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
