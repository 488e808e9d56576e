"""Train / eval / prefill / decode step functions.

Ported from ``repro/train/train_step.py``. ``make_train_step(cfg,
opt_cfg)`` returns a plain function (model, opt_state, batch) -> (model,
opt_state, metrics): the loss and its gradients by autograd through the
model's kernels (each with its backward kernel on the card), then one
AdamW step (``train/optimizer.py``) that updates the model's parameters
in place. The JAX package's ``jax.value_and_grad`` + ``jit`` has no
other counterpart here: PyTorch runs eagerly. ``deterministic`` is the
training path's setting on the card: index backward passes (the
embedding lookup's, the MoE dispatch's gather of a token's k copies)
scatter with float atomics unless PyTorch's deterministic algorithms
are on, and a resumed run must repeat an uninterrupted one bit for bit.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np
import torch

from repro_torch.models import transformer
from repro_torch.train import optimizer as opt


@contextlib.contextmanager
def deterministic():
    """PyTorch's deterministic algorithms on, an operation that has none
    raising instead of changing bits quietly, without filling fresh
    tensors with NaN (no operation of a training step reads memory it
    never wrote: ``benchmarks/torch_step_bits.py`` runs the step with the
    fill on and gets the same bits); the previous settings restored on
    exit. cuBLAS needs ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the
    environment before its first handle (``launch/train.py`` sets it)."""
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    det = getattr(torch.utils, "deterministic", None)
    fill = getattr(det, "fill_uninitialized_memory", None)
    torch.use_deterministic_algorithms(True, warn_only=False)
    if fill is not None:
        det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        if fill is not None:
            det.fill_uninitialized_memory = fill


def to_batch(batch: Dict, device) -> Dict[str, torch.Tensor]:
    """A pipeline batch (NumPy ``tokens`` and ``labels`` (B, S), optional
    ``prefix_embeds``) as tensors on ``device``, the token ids int64."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v)) if not isinstance(
            v, torch.Tensor) else v
        out[k] = (t.long() if k in ("tokens", "labels") else t).to(device)
    return out


def _check(cfg, model) -> None:
    if model.cfg != cfg:
        raise ValueError(f"the step was built for {cfg.name}, the model is "
                         f"{model.cfg.name} or another config of it")


def make_train_step(cfg, opt_cfg: opt.AdamWConfig):
    def train_step(model, opt_state: opt.OptState, batch):
        _check(cfg, model)
        params = dict(model.named_parameters())
        for p in params.values():
            p.grad = None
        loss = transformer.train_loss(model, to_batch(batch, model.device))
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        _, opt_state, metrics = opt.apply_updates(
            opt_cfg, params, grads, opt_state, decay=model.decay_mask())
        for p in params.values():
            p.grad = None
        del grads
        return model, opt_state, dict(metrics, loss=loss.detach())
    return train_step


def make_prefill_step(cfg):
    def prefill_step(model, batch):
        _check(cfg, model)
        b = to_batch(batch, model.device)
        return transformer.prefill(model, b["tokens"], b.get("prefix_embeds"))
    return prefill_step


def make_decode_step(cfg):
    def decode_step(model, caches, batch):
        _check(cfg, model)
        b = to_batch(batch, model.device)
        return transformer.decode_step(model, caches, b["tokens"], b["pos"])
    return decode_step


def make_eval_step(cfg):
    def eval_step(model, batch):
        _check(cfg, model)
        with torch.no_grad():
            return transformer.train_loss(model, to_batch(batch, model.device))
    return eval_step
