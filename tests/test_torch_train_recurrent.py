"""Training of the recurrent zoo models: jamba-v0.1-52b (Mamba, attention
and MoE) and xlstm-125m (mLSTM, sLSTM) against the JAX package, with
the checks and tolerances of ``tests/test_torch_train.py`` (the Mamba scan
under autograd runs out of place, to the in-place scan's bits).
"""
import pytest

pytest.importorskip("torch")

from _torch_train_cases import (check_decay_follows_the_jax_tree,  # noqa: E402
                                check_loss_and_every_gradient_match_jax,
                                check_remat_gives_the_same_bits,
                                check_three_adamw_steps_match_jax, make_case)

ARCHS = ("jamba-v0.1-52b", "xlstm-125m")


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return make_case(request.param)


def test_loss_and_every_gradient_match_jax(case):
    check_loss_and_every_gradient_match_jax(case)


def test_three_adamw_steps_match_jax(case):
    check_three_adamw_steps_match_jax(case)


def test_remat_gives_the_same_bits(case):
    check_remat_gives_the_same_bits(case)


def test_decay_follows_the_jax_tree(case):
    check_decay_follows_the_jax_tree(case)
