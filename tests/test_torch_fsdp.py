"""FSDP over "data" (the JAX package's "embed" -> "data" placement) on
gloo ranks spawned as processes (``tests/_torch_dp_worker.py``), held
to the JAX package: two ranks of granite-moe-3b-a800m without remat
(MoE; the same with remat, and h2o-danube-1.8b, are in
``tests/test_torch_data_parallel.py``) and of xlstm-125m (recurrent, its
embedding tied: one gather read by the embedding and the LM head, so
one reduce-scatter) against the JAX package's train step on the global
batch, with the checks of ``test_torch_data_parallel.
check_fsdp_ranks_match_jax``: loss 1e-5, gradients 1e-4, three AdamW
steps at lr 1e-4 within 1e-5; each rank's gradient slices bit for bit
``sum_gradients``' slices of the whole; the replicated scalars and the
gathered parameters bit for bit equal on both ranks.
``tests/test_torch_fsdp_state.py`` holds the serving steps, the
checkpoints and the refusals.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_data_parallel import check_fsdp_ranks_match_jax  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("arch,remat", [("granite-moe-3b-a800m", False),
                                        ("xlstm-125m", False)])
def test_two_fsdp_ranks_match_jax(arch, remat, tmp_path, monkeypatch):
    check_fsdp_ranks_match_jax(arch, remat, tmp_path, monkeypatch)
