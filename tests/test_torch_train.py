"""Training of the LM zoo: the port against the JAX package.

Five smoke configs, each reaching a part of the training path:
granite-moe-3b-a800m (MoE with its aux losses), h2o-danube-1.8b (window
attention, sequence past the window) and llava-next-34b (prefix
embeddings, sliced off before the loss) here; jamba-v0.1-52b (Mamba and
MoE) and xlstm-125m (mLSTM and sLSTM) in
``tests/test_torch_train_recurrent.py``, with the same checks
(``tests/_torch_train_cases.py``). The JAX package's parameters are carried
across by ``params_from_jax(..., trainable=True)``, with wq and wk at
their true fan-in (F3 in ROADMAP.md), and the same NumPy batch goes
through both packages:

  * ``train_loss`` within 1e-5 of the JAX package's;
  * every gradient within 1e-4 of its JAX counterpart, relative to the
    JAX gradient's largest entry (``jax.value_and_grad``); the port's
    padded query heads and experts are dropped, whose JAX gradients are
    exactly zero;
  * three ``make_train_step`` steps leave every parameter within 1e-5 of
    three steps of the JAX package's ``apply_updates``, at lr 1e-4 (an
    update of about 1e-4 a step): AdamW's normalised step turns a
    rounding-level gradient difference on an entry near ``eps`` into up to
    lr / 100 (1.35e-5 on one entry of granite's wv at lr 1e-3);
  * the remat path (each block checkpointed) gives the same loss and
    gradients, bit for bit, as the plain one.

The port runs on the CPU, through the kernels' plain versions and their
plain backward passes, with one torch thread.
"""
import pytest

pytest.importorskip("torch")

from _torch_train_cases import (check_decay_follows_the_jax_tree,  # noqa: E402
                                check_loss_and_every_gradient_match_jax,
                                check_remat_gives_the_same_bits,
                                check_three_adamw_steps_match_jax, make_case)

ARCHS = ("granite-moe-3b-a800m", "h2o-danube-1.8b", "llava-next-34b")


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
