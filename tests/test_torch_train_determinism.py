"""The training path's deterministic mode (``train_step.deterministic``).

The mode raises on an operation without a deterministic path, instead of
warning and changing bits quietly, and a training step of each trainable
zoo family runs under it on the CPU without meeting one and repeats its
bits after other work in the same process. The card's side is
``tests/test_torch_cuda.py::test_training_step_bits_do_not_follow_history``
and ``chip_smoke.py``'s step-bits check:

    PYTHONPATH=src python -m pytest -q tests/test_torch_train_determinism.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.base import get_smoke_config  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.train import train_step as steps  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    """Several test processes may run at once (xdist); one thread each."""
    was = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(was)


def test_the_mode_raises_and_is_restored():
    """Inside: deterministic algorithms on, not warn-only, fresh tensors
    not filled; an operation with no deterministic path (``put_``
    without accumulation) raises. Outside: the previous settings."""
    det = torch.utils.deterministic
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled(),
              det.fill_uninitialized_memory)
    idx, src = torch.tensor([1, 1]), torch.tensor([1.0, 2.0])
    with steps.deterministic():
        assert torch.are_deterministic_algorithms_enabled()
        assert not torch.is_deterministic_algorithms_warn_only_enabled()
        assert not det.fill_uninitialized_memory
        with pytest.raises(RuntimeError, match="deterministic"):
            torch.zeros(4).put_(idx, src)
    assert (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            det.fill_uninitialized_memory) == before
    torch.zeros(4).put_(idx, src)


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "jamba-v0.1-52b",
                                  "xlstm-125m"])
def test_a_step_meets_no_nondeterministic_operation(arch):
    """One loss and backward of the smoke config (MoE dispatch, Mamba,
    mLSTM and sLSTM, the chunked cross-entropy, remat) under the mode:
    nothing raises, and every gradient has the same bits again after
    other work (odd-sized allocations kept, a step at another batch)."""
    cfg = get_smoke_config(arch)
    model = tf.init_model(cfg, torch.Generator().manual_seed(0),
                          device="cpu", trainable=True)
    rng = np.random.default_rng(0)
    seq = 64
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (2, seq))),
             "labels": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (2, seq)))}

    def step(b):
        model.zero_grad(set_to_none=True)
        with steps.deterministic():
            tf.train_loss(model, b).backward()
        out = {n: p.grad.clone() for n, p in model.named_parameters()
               if p.grad is not None}
        model.zero_grad(set_to_none=True)
        return out

    fresh = step(batch)
    kept = [torch.empty(int(n)) for n in rng.integers(1, 100_000, 20)][::2]
    step({k: v[:1] for k, v in batch.items()})
    again = step(batch)
    kept.clear()   # the held allocations are let go
    assert fresh.keys() == again.keys() and len(fresh) > 0
    assert all(torch.equal(fresh[n], again[n]) for n in fresh)
