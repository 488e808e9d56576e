"""The port's "model" axis on jamba-v0.1-52b's smoke config (Mamba's
d_inner split over 2 gloo ranks, 4 experts padded to 16, a vocab of 255
that does not divide and stays whole), held to the JAX package's
unsharded loss, gradients, prefill and decode ticks as
``tests/test_torch_model_axis.py`` holds the dense and MoE configs,
with that file's checks.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_model_axis import check_two_model_ranks_match_jax  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def test_two_model_ranks_match_jax(tmp_path, monkeypatch):
    check_two_model_ranks_match_jax("jamba-v0.1-52b", tmp_path, monkeypatch)
