"""On-camera operator family: AlexNet-style micro-CNNs in PyTorch (§7).

Variants span conv depth (2-5), channel width (8/16/32), dense width
(16/32/64) and input size (25/50/100), times an input *region* carved
from the spatial-skew heatmap — exactly the paper's breeding axes.
Each operator outputs (presence_logit, count): rankers sort frames by
presence probability (Retrieval) or predicted count (max-Count);
filters threshold presence probability with calibrated (lo, hi).

Parameters are plain dicts of tensors in the JAX package's layout
(``{"convs": [{"w", "b"}, ...], "dense": {...}, "head": {...}}``, conv
weights HWIO, activations NHWC), so ``params_from_jax`` carries its
weights across unchanged. Batched inference goes through
``core/runtime.OperatorRuntime``, which runs the conv stack through the
hand-written CUDA kernel on the card. ``apply_operator`` /
``score_frames`` below are the plain forward that training and the
runtime's correctness tests use; like the JAX package's training, which
runs XLA's convolution and no Pallas kernel, training runs PyTorch's own
convolution and autograd.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.ops import Device, resolve_device
from repro_torch.kernels.ref import fp32_conv, same_pad


@dataclass(frozen=True)
class OperatorArch:
    name: str
    conv_layers: int          # 2..5
    channels: int             # 8 | 16 | 32
    dense: int                # 16 | 32 | 64
    input_size: int           # 25 | 50 | 100
    region: Optional[Tuple[int, int, int, int]] = None  # frame crop (px)

    @property
    def flops(self) -> float:
        """Per-frame inference cost model (drives the camera FPS).

        Charges AlexNet-style stride-1 conv + 2x2 pool per layer — the
        paper's actual operator family — which calibrates the family to
        the measured 27x-1000x-realtime band on Rpi3 (§8). The host
        executes a stride-2 surrogate with the same accuracy trends;
        simulated time always uses this model (DESIGN.md §8)."""
        s = self.input_size
        c_in = 3
        total = 0.0
        for i in range(self.conv_layers):
            # stride-1 SAME conv at s x s, then 2x2 pool
            total += 2.0 * s * s * self.channels * 9 * c_in
            c_in = self.channels
            s = max(1, (s + 1) // 2)
        feat = s * s * c_in
        total += 2.0 * feat * self.dense + 2.0 * self.dense * 2
        return total

    @property
    def param_count(self) -> int:
        c_in, s = 3, self.input_size
        n = 0
        for _ in range(self.conv_layers):
            n += 9 * c_in * self.channels + self.channels
            c_in = self.channels
            s = max(1, (s + 1) // 2)
        n += s * s * c_in * self.dense + self.dense
        n += self.dense * 2 + 2
        return n

    @property
    def size_bytes(self) -> float:
        return self.param_count * 4.0


def init_operator(arch: OperatorArch, generator: torch.Generator,
                  device: Device = None) -> dict:
    """He-style init from ``generator``. ``torch.Generator`` and
    ``jax.random`` give different numbers from one seed, so comparisons
    with the JAX package carry its params across (``params_from_jax``)."""
    device = resolve_device(device)

    def normal(*shape):
        return torch.randn(shape, generator=generator,
                           device=generator.device).to(device)

    def zeros(n):
        return torch.zeros(n, device=device)

    params = {"convs": []}
    c_in, s = 3, arch.input_size
    for _ in range(arch.conv_layers):
        w = normal(3, 3, c_in, arch.channels) * (2.0 / (9 * c_in)) ** 0.5
        params["convs"].append({"w": w, "b": zeros(arch.channels)})
        c_in = arch.channels
        s = max(1, (s + 1) // 2)
    feat = s * s * c_in
    params["dense"] = {
        "w": normal(feat, arch.dense) * (2.0 / feat) ** 0.5,
        "b": zeros(arch.dense)}
    params["head"] = {
        "w": normal(arch.dense, 2) * (1.0 / arch.dense) ** 0.5,
        "b": zeros(2)}
    return params


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, i.e. ``logaddexp(x, 0)``. ``F.softplus``
    returns x itself above 20, about 2e-9 away."""
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def _conv_same(h: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> torch.Tensor:
    """3x3/stride-2 SAME conv + bias + ReLU on NCHW ``h``, HWIO ``w``,
    padded as XLA pads (the smaller half before)."""
    _, top, bottom = same_pad(h.shape[2], 2)
    _, left, right = same_pad(h.shape[3], 2)
    h = F.conv2d(F.pad(h, (left, right, top, bottom)), w.permute(3, 2, 0, 1),
                 stride=2)
    return torch.relu(h + b[:, None, None])


def apply_operator(params: dict, x: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (N, s, s, 3) float32 NHWC -> (presence_logit (N,), count (N,))."""
    with fp32_conv():
        h = x.permute(0, 3, 1, 2)
        for c in params["convs"]:
            h = _conv_same(h, c["w"], c["b"])
    # flatten in NHWC order, as the JAX package does: the dense weights'
    # rows are laid out (H, W, C)
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    h = torch.relu(h @ params["dense"]["w"] + params["dense"]["b"])
    out = h @ params["head"]["w"] + params["head"]["b"]
    return out[:, 0], softplus(out[:, 1])


def _loss_fn(params, x, y_present, y_count, train_count: bool):
    logit, cnt = apply_operator(params, x)
    bce = torch.mean(
        torch.clamp_min(logit, 0) - logit * y_present +
        torch.log1p(torch.exp(-torch.abs(logit))))
    if train_count:
        d = cnt - y_count
        huber = torch.mean(torch.where(torch.abs(d) < 2.0, 0.5 * d ** 2,
                                       2.0 * torch.abs(d) - 2.0))
        return bce + 0.3 * huber
    return bce


def _leaves(params: dict) -> List[torch.Tensor]:
    out = []
    for c in params["convs"]:
        out += [c["w"], c["b"]]
    return out + [params["dense"]["w"], params["dense"]["b"],
                  params["head"]["w"], params["head"]["b"]]


def _unflatten(leaves: List[torch.Tensor], n_convs: int) -> dict:
    it = iter(leaves)
    convs = [{"w": next(it), "b": next(it)} for _ in range(n_convs)]
    dense = {"w": next(it), "b": next(it)}
    return {"convs": convs, "dense": dense, "head": {"w": next(it),
                                                     "b": next(it)}}


def _adam_step(leaves, m, v, n_convs, xb, bright, ypb, ycb, bc1, bc2, decay,
               lr, train_count: bool):
    """One train step: brightness augment, gradient, Adam — the update of
    the JAX package's ``_adam_step``, with decoupled multiplicative decay
    ``decay * p - lr * (m / bc1) / (sqrt(v / bc2) + 1e-8)``. The scalars
    are float32 values computed on the host; new tensors are made for
    params, m and v (callers may still score with the incoming params)."""
    with fp32_conv():
        p = [t.detach().requires_grad_(True) for t in leaves]
        xb = torch.clamp(xb * bright, 0.0, 1.0)
        loss = _loss_fn(_unflatten(p, n_convs), xb, ypb, ycb, train_count)
        g = torch.autograd.grad(loss, p)
    with torch.no_grad():
        m = [0.9 * m_ + 0.1 * g_ for m_, g_ in zip(m, g)]
        v = [0.999 * v_ + 0.001 * g_ ** 2 for v_, g_ in zip(v, g)]
        new = [decay * p_ - lr * (m_ / bc1) / (torch.sqrt(v_ / bc2) + 1e-8)
               for p_, m_, v_ in zip(leaves, m, v)]
    return new, m, v


def train_operator(arch: OperatorArch, params: Optional[dict], crops,
                   labels, counts, *, steps: int = 120, batch: int = 128,
                   lr: float = 2e-3, seed: int = 0,
                   train_count: bool = True, device: Device = None) -> dict:
    """Adam fine-tune on (crops, labels, counts); resumable (online
    training keeps improving the same operator as more samples arrive).
    Draws the same minibatches and brightness factors from the same
    ``np.random.default_rng(seed)`` stream as the JAX package."""
    device = resolve_device(device)
    x = torch.as_tensor(np.asarray(crops, np.float32), device=device)
    yp = torch.as_tensor(np.asarray(labels, np.float32), device=device)
    yc = torch.as_tensor(np.asarray(counts, np.float32), device=device)
    if params is None:
        params = init_operator(arch, torch.Generator().manual_seed(seed),
                               device)
    leaves = [t.to(device) for t in _leaves(params)]
    m = [torch.zeros_like(t) for t in leaves]
    v = [torch.zeros_like(t) for t in leaves]
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    # wall-clock scaling for expensive ops (simulated time charged apart)
    batch = int(np.clip(batch * 8e7 / max(arch.flops, 1), 32, batch))
    # balanced minibatches: surveillance positives are rare (<10%); plain
    # sampling collapses the scorer to "always negative"
    lab = np.asarray(labels) > 0.5
    pos_idx = np.nonzero(lab)[0]
    neg_idx = np.nonzero(~lab)[0]
    balanced = len(pos_idx) > 0 and len(neg_idx) > 0
    wd = 1e-4
    decay = float(np.float32(1 - lr * wd))
    lr32 = float(np.float32(lr))
    for t in range(1, steps + 1):
        if balanced:
            half = min(batch, n) // 2
            sel = np.concatenate([
                rng.choice(pos_idx, half, replace=True),
                rng.choice(neg_idx, min(batch, n) - half, replace=True)])
        else:
            sel = rng.integers(0, n, size=min(batch, n))
        # brightness augmentation: the scene dims over the day; operators
        # must generalize across capture hours
        bright = np.asarray(rng.uniform(0.7, 1.3, (len(sel), 1, 1, 1)),
                            np.float32)
        sel_t = torch.as_tensor(sel, device=device)
        leaves, m, v = _adam_step(
            leaves, m, v, arch.conv_layers, x[sel_t],
            torch.as_tensor(bright, device=device), yp[sel_t], yc[sel_t],
            float(np.float32(1 - 0.9 ** t)), float(np.float32(1 - 0.999 ** t)),
            decay, lr32, train_count)
    return _unflatten(leaves, arch.conv_layers)


def score_frames(params: dict, crops) -> Tuple[np.ndarray, np.ndarray]:
    """Plain reference scoring on the params' device -> (presence_prob,
    count) as float32 numpy.

    Executors must NOT call this in per-chunk loops — use
    ``core/runtime.OperatorRuntime`` (chunked, through the kernel)."""
    device = params["head"]["b"].device
    with torch.no_grad():
        logit, cnt = apply_operator(
            params, torch.as_tensor(np.asarray(crops, np.float32),
                                    device=device))
    return torch.sigmoid(logit).cpu().numpy(), cnt.cpu().numpy()


def params_from_jax(tree: dict, device: Device = None) -> dict:
    """The JAX package's params, as numpy arrays (``jax.tree_util.
    tree_map(np.asarray, params)``), to this package's dict of tensors
    on ``device``: same layout, same dtype, same values."""
    device = resolve_device(device)

    def leaf(a):
        return torch.from_numpy(np.array(a, copy=True)).to(device)

    return {"convs": [{"w": leaf(c["w"]), "b": leaf(c["b"])}
                      for c in tree["convs"]],
            "dense": {"w": leaf(tree["dense"]["w"]),
                      "b": leaf(tree["dense"]["b"])},
            "head": {"w": leaf(tree["head"]["w"]),
                     "b": leaf(tree["head"]["b"])}}


def params_to_numpy(params: dict) -> dict:
    """The inverse of ``params_from_jax``: numpy arrays in the same
    layout, which ``jax.numpy.asarray`` takes as they are."""
    def leaf(t):
        return t.detach().cpu().numpy()

    return {"convs": [{"w": leaf(c["w"]), "b": leaf(c["b"])}
                      for c in params["convs"]],
            "dense": {"w": leaf(params["dense"]["w"]),
                      "b": leaf(params["dense"]["b"])},
            "head": {"w": leaf(params["head"]["w"]),
                     "b": leaf(params["head"]["b"])}}


def calibrate_thresholds(scores: np.ndarray, labels: np.ndarray,
                         err: float = 0.01) -> Tuple[float, float]:
    """(lo, hi) for filters: score<lo => N, score>hi => P, else unresolved,
    s.t. estimated FN and FP rates are <= err (§6.2)."""
    scores = np.asarray(scores, np.float64)
    labels = np.asarray(labels, bool)
    order = np.argsort(scores, kind="stable")
    s, lab = scores[order], labels[order]
    n_pos = max(lab.sum(), 1)
    n_neg = max((~lab).sum(), 1)
    # lo: largest cut with cumulative positives below <= err * n_pos
    cum_pos = np.cumsum(lab)
    k = int(np.searchsorted(cum_pos, err * n_pos, side="right"))
    lo = s[k - 1] + 1e-9 if k > 0 else 0.0
    # hi: smallest cut with negatives above <= err * n_neg
    cum_neg_above = np.cumsum((~lab)[::-1])[::-1]
    ks = np.nonzero(cum_neg_above <= err * n_neg)[0]
    hi = s[ks[0]] - 1e-9 if len(ks) else 1.0
    if hi < lo:
        lo = hi
    return float(lo), float(hi)


def gamma_of(scores: np.ndarray, lo: float, hi: float) -> float:
    """Resolvable fraction under thresholds — the gamma_op of §6.2."""
    s = np.asarray(scores)
    return float(np.mean((s < lo) | (s > hi))) if len(s) else 0.0
