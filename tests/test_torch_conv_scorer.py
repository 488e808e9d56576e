"""The port's conv scorer against the JAX package's.

On the CPU the wrapper takes its plain version (``kernels/ref.py``);
both are held against ``repro.kernels.ref.conv_scorer`` and the Pallas
kernel in interpret mode at the tolerance of ``tests/test_kernels.py``
(rtol = atol = 1e-4), over every conv layer shape of the reduced
operator family. The CUDA kernel itself runs only on the card:
``tests/test_torch_cuda.py`` holds it against the plain version there.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from numpy.testing import assert_allclose  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.conv_scorer import conv_scorer as pallas_conv  # noqa: E402
from repro_torch.kernels import conv_scorer as cs  # noqa: E402
from repro_torch.kernels import build, ops as kops, ref  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)

# (H, Cin, Cout) of every conv layer of the reduced family's four archs:
# (2, 8, 16, 25), (3, 16, 32, 50), (4, 16, 32, 50), (5, 32, 64, 100)
FAMILY_LAYERS = [(25, 3, 8), (13, 8, 8), (50, 3, 16), (25, 16, 16),
                 (13, 16, 16), (7, 16, 16), (100, 3, 32), (50, 32, 32),
                 (25, 32, 32), (13, 32, 32), (7, 32, 32)]


def _inputs(n, h, cin, cout, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, h, cin)).astype(np.float32)
    w = (rng.standard_normal((3, 3, cin, cout)) /
         np.sqrt(9 * cin)).astype(np.float32)
    b = rng.standard_normal((cout,)).astype(np.float32)
    return x, w, b


def _port(x, w, b):
    return cs.conv_scorer(torch.from_numpy(x), torch.from_numpy(w),
                          torch.from_numpy(b)).numpy()


@pytest.mark.parametrize("i", range(len(FAMILY_LAYERS)),
                         ids=[f"H{h}_{ci}to{co}" for h, ci, co in FAMILY_LAYERS])
def test_plain_conv_matches_jax_reference_and_pallas(i):
    h, cin, cout = FAMILY_LAYERS[i]
    n = 3 + i % 7                      # 3..9, mostly not a multiple of 8
    x, w, b = _inputs(n, h, cin, cout, seed=i)
    got = _port(x, w, b)
    ho = -(-h // 2)
    assert got.shape == (n, ho, ho, cout)
    assert_allclose(got, np.asarray(jref.conv_scorer(x, w, b)), **TOL)
    assert_allclose(got, np.asarray(pallas_conv(x, w, b, interpret=True)),
                    **TOL)


@pytest.mark.parametrize("h,first,last", [(6, 9.0, 4.0), (7, 4.0, 4.0)])
def test_same_padding_is_asymmetric_for_even_sizes(h, first, last):
    """XLA pads the smaller half before: an even H at stride 2 gets no
    row at the top and one at the bottom, so the first output sees the
    full 3x3 window and only the last row and column see padding. An
    odd H gets one row each side. ``F.conv2d(padding=1)`` pads the top
    for every H."""
    x = np.ones((1, h, h, 1), np.float32)
    w = np.ones((3, 3, 1, 1), np.float32)
    b = np.zeros((1,), np.float32)
    got = _port(x, w, b)[0, :, :, 0]
    assert got[0, 0] == first and got[-1, -1] == last
    assert got[1, 1] == 9.0
    assert_allclose(got, np.asarray(jref.conv_scorer(x, w, b))[0, :, :, 0])
    assert ref.same_pad(h, 2)[1:] == ((0, 1) if h % 2 == 0 else (1, 1))


def test_wrapper_checks_inputs_and_counts_only_kernel_launches():
    x, w, b = (torch.from_numpy(a) for a in _inputs(2, 13, 8, 8, seed=0))
    before = cs.conv_scorer.launches
    cs.conv_scorer(x, w, b)                      # CPU: the plain version
    assert cs.conv_scorer.launches == before
    with pytest.raises(TypeError):
        cs.conv_scorer(x.double(), w, b)
    with pytest.raises(ValueError):
        cs.conv_scorer(x, w[:, :, :4], b)
    with pytest.raises(ValueError):
        cs.conv_scorer(x, w, b[:4])
    with pytest.raises(ValueError):                    # x on meta, w not
        cs.conv_scorer(x.to("meta"), w, b)
    # meta (the dry run) is checked as the card is and launches nothing:
    # Cout 12 is not one the kernel compiles
    with pytest.raises(ValueError):
        cs.conv_scorer(x.to("meta"), torch.zeros(3, 3, 8, 12, device="meta"),
                       torch.zeros(12, device="meta"))
    m = cs.conv_scorer(x.to("meta"), w.to("meta"), b.to("meta"))
    assert m.device.type == "meta" and m.shape == (2, 7, 7, 8)
    assert cs.conv_scorer.launches == before
    out = cs.conv_scorer(x[:0], w, b)
    assert out.shape == (0, 7, 7, 8)


def test_conv_scorer_fn_picks_by_device(monkeypatch):
    x, w, b = (torch.from_numpy(a) for a in _inputs(3, 25, 3, 8, seed=1))
    fn = kops.conv_scorer_fn("cpu")
    assert fn.func is cs.conv_scorer
    assert torch.equal(fn(x, w, b), ref.conv_scorer(x, w, b))
    with pytest.raises(ValueError, match="meta"):
        kops.conv_scorer_fn("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        kops.conv_scorer_fn()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert kops.conv_scorer_fn().func is cs.conv_scorer
    assert kops.conv_scorer_fn("cuda").func is cs.conv_scorer


def test_build_is_keyed_by_source_hash():
    path = build.library_path("conv_scorer")
    assert path.parent == build.BUILD_DIR
    assert path.parent.parts[-2:] == ("build", "repro_torch")
    assert path == build.library_path("conv_scorer")
    assert path.name.startswith("libconv_scorer_")
    assert "arch=compute_90a,code=sm_90a" in build.NVCC_FLAGS
