"""Tests of the port that need an NVIDIA card; they skip elsewhere.

The file imports neither JAX nor the JAX package, so it runs on a
machine with only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro_torch.core import operators as ops  # noqa: E402
from repro_torch.core import runtime as rt_mod  # noqa: E402
from repro_torch.kernels import conv_scorer as cs, ref  # noqa: E402

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
