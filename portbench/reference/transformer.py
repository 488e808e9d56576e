"""Plain PyTorch reference of the benchmark's decoder-only transformers.

What a configuration file under ``portbench/configs`` states, written
from the published description and nothing of the program, with the
numerics of the file's ``as_run`` group: the token embedding times
``embedding_multiplier``, then per layer an RMSNorm, grouped-query
attention with rotary positions (split-halves layout, float32 angles)
over a causal, optionally sliding, window, scores times
``attention_multiplier``, the residual add of the output times
``residual_multiplier``, an RMSNorm and the feed-forward network of the
file's ``ffn`` kind (``reference/<ffn>.py``), the residual add; a final
RMSNorm and the output head (the embedding table where it is tied),
divided by ``logits_scaling``.

Float32 throughout with TF32 off (``no_tf32``), computed a layer at a
time: each layer is checkpointed, so only the layers' inputs are kept
for the backward, and attention runs in blocks of queries. ``precision="fp8"`` is
the control: every matrix product's inputs, forward and backward,
rounded to float8 e4m3 with one scale a tensor, as an fp8 path would
run it, the sums in float32.

The weights are drawn again here from the seed (``portbench/weights``);
nothing of the program's is read.
"""
from __future__ import annotations

import contextlib
import importlib
import math
from typing import Dict, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from portbench import weights as W

FP8_MAX = 448.0            # float8 e4m3's largest finite value
Q_BLOCK = 1024             # query rows an attention block takes


@contextlib.contextmanager
def no_tf32():
    """Float32 products in float32: TF32 off for cuBLAS and cuDNN."""
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = was


def fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude maps to 448), back in float32."""
    s = t.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


class FP8Matmul(torch.autograd.Function):
    """a @ b with both inputs rounded to fp8, and in the backward the
    output's gradient too: each product of the pass takes fp8 inputs and
    sums in float32."""

    @staticmethod
    def forward(ctx, a, b):
        a, b = fp8(a), fp8(b)
        ctx.save_for_backward(a, b)
        return a @ b

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = fp8(g)
        return g @ b.transpose(-1, -2), a.transpose(-1, -2) @ g


def mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    """a @ b in float32, or in fp8 (the control: ``FP8Matmul``)."""
    if precision == "fp8":
        return FP8Matmul.apply(a, b)
    return a @ b


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, D) rotated by ``positions`` (S,): pairs (i, i + D/2)."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, device=x.device,
                                       dtype=torch.float32) / half)
    ang = positions.float()[:, None] * inv
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, window: Optional[int], scale: float,
              precision: str) -> torch.Tensor:
    """Causal attention, key j kept by query i iff j <= i and, with a
    window, j > i - window. q (B, S, H, D), k and v (B, S, KV, D), query
    head h reading kv head h // (H / KV). In blocks of ``Q_BLOCK`` query
    rows against the keys they can see."""
    B, S, H, D = q.shape
    g = H // k.shape[2]
    k = k.repeat_interleave(g, dim=2).transpose(1, 2)        # (B, H, S, D)
    v = v.repeat_interleave(g, dim=2).transpose(1, 2)
    q = q.transpose(1, 2)
    outs = []
    for a in range(0, S, Q_BLOCK):
        b = min(a + Q_BLOCK, S)
        k0 = 0 if window is None else max(0, a - window + 1)
        qpos = torch.arange(a, b, device=q.device)[:, None]
        kpos = torch.arange(k0, b, device=q.device)[None, :]
        keep = kpos <= qpos
        if window is not None:
            keep = keep & (kpos > qpos - window)
        s = mm(q[:, :, a:b], k[:, :, k0:b].transpose(-1, -2), precision)
        p = torch.softmax((s * scale).masked_fill(~keep, float("-inf")), -1)
        outs.append(mm(p, v[:, :, k0:b], precision))
    return torch.cat(outs, dim=2).transpose(1, 2)           # (B, S, H, D)


class Model:
    """A configuration file's model with weights from ``seed`` (float32,
    on ``device``). ``ffn``: the module ``reference/<cfg['ffn']>.py``,
    whose ``forward(cfg, w, h, precision)`` gives the FFN's output and
    its auxiliary losses."""

    def __init__(self, cfg: Dict, seed: int, device, precision: str = "float32"):
        self.cfg, self.seed, self.device = cfg, seed, torch.device(device)
        self.precision = precision
        self.ffn = importlib.import_module(f"portbench.reference.{cfg['ffn']}")
        run = cfg["as_run"]
        self.embed_mult = run["embedding_multiplier"]
        self.attn_scale = run["attention_multiplier"]
        self.residual = run["residual_multiplier"]
        self.logit_div = run["logits_scaling"]

    # -- weights ------------------------------------------------------------

    def draw(self) -> Dict[str, torch.Tensor]:
        """Every leaf by the port's parameter name, float32."""
        cfg = self.cfg
        out = dict(W.draw_top(cfg, self.seed, self.device))
        for i in range(cfg["num_hidden_layers"]):
            for n, t in W.draw_layer(cfg, self.seed, i, self.device).items():
                out[f"blocks.{i}.{n}"] = t
        return out

    @staticmethod
    def layer(params: Dict[str, torch.Tensor], i: int) -> Dict[str, torch.Tensor]:
        p = f"blocks.{i}."
        return {n[len(p):]: t for n, t in params.items() if n.startswith(p)}

    # -- the forward --------------------------------------------------------

    def embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens] * self.embed_mult

    def block(self, w: Dict[str, torch.Tensor], x: torch.Tensor,
              positions: torch.Tensor):
        """One layer over x (B, S, d): (x, lb_loss, z_loss)."""
        cfg, pr = self.cfg, self.precision
        B, S, d = x.shape
        H, KV, D = (cfg["num_attention_heads"], cfg["num_key_value_heads"],
                    cfg["head_dim"])
        h = rmsnorm(x, w["norm1.scale"], cfg["rms_norm_eps"])
        q = mm(h, w["mixer.wq"].reshape(d, H * D), pr).view(B, S, H, D)
        k = mm(h, w["mixer.wk"].reshape(d, KV * D), pr).view(B, S, KV, D)
        v = mm(h, w["mixer.wv"].reshape(d, KV * D), pr).view(B, S, KV, D)
        theta = cfg["rope_theta"]
        o = attention(rope(q, positions, theta), rope(k, positions, theta), v,
                      cfg.get("sliding_window"), self.attn_scale, pr)
        x = x + self.residual * mm(o.reshape(B, S, H * D),
                                   w["mixer.wo"].reshape(H * D, d), pr)
        h = rmsnorm(x, w["norm2.scale"], cfg["rms_norm_eps"])
        y, lb, z = self.ffn.forward(cfg, w, h, pr)
        return x + self.residual * y, lb, z

    def head(self, params, x: torch.Tensor) -> torch.Tensor:
        """Final norm and output head: logits (..., V), float32."""
        x = rmsnorm(x, params["final_norm.scale"], self.cfg["rms_norm_eps"])
        table = params.get("unembed", params["embed"])
        return mm(x, table.T, self.precision) / self.logit_div

    # -- training -----------------------------------------------------------

    def loss(self, params, tokens: torch.Tensor, labels: torch.Tensor):
        """The training loss: mean next-token NLL plus the FFN's auxiliary
        losses summed over the layers, weighted by the file's ``loss``.
        Each layer is checkpointed."""
        cfg = self.cfg
        x = self.embed(params, tokens)
        positions = torch.arange(tokens.shape[1], device=x.device)
        lb = z = torch.zeros((), device=x.device)
        for i in range(cfg["num_hidden_layers"]):
            x, lb_i, z_i = checkpoint(self._block_by_index, params, i, x,
                                      positions, use_reentrant=False)
            lb, z = lb + lb_i, z + z_i
        nll = torch.zeros((), device=x.device)
        B, S = labels.shape
        c = cfg["loss"]["logit_chunk"]
        for a in range(0, S, c):
            nll = nll + checkpoint(self._nll, params, x[:, a:a + c],
                                   labels[:, a:a + c], use_reentrant=False)
        w = cfg["loss"]
        return nll / (B * S) + w["aux_lb_weight"] * lb + w["aux_z_weight"] * z

    def _block_by_index(self, params, i, x, positions):
        return self.block(self.layer(params, i), x, positions)

    def _nll(self, params, x, labels):
        logits = self.head(params, x)
        return (torch.logsumexp(logits, -1) -
                logits.gather(-1, labels[..., None])[..., 0]).sum()


def lr_at(opt: Dict, step: int) -> float:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine down
    to ``min_lr_frac`` of it at ``total_steps``."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    t = min(max((step - opt["warmup_steps"]) /
                max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * \
        0.5 * (1 + math.cos(math.pi * t))
    return opt["lr"] * warm * frac


@torch.no_grad()
def adamw(opt: Dict, params, grads, m, v, step: int) -> Dict[str, float]:
    """One AdamW step in place: gradients clipped by their global norm,
    bias-corrected moments, ``eps`` outside the square root, decoupled
    decay on every tensor but the final norm's scale. Returns the norm
    of each clipped gradient, as the optimizer takes it."""
    gn = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
    scale = min(1.0, opt["clip_norm"] / (gn + 1e-9))
    lr = lr_at(opt, step)
    b1, b2 = opt["b1"], opt["b2"]
    b1c, b2c = 1 - b1 ** step, 1 - b2 ** step
    norms = {}
    for n, p in params.items():
        g = grads[n] * scale
        norms[n] = float(g.norm())
        m[n].mul_(b1).add_((1 - b1) * g)
        v[n].mul_(b2).add_((1 - b2) * g.square())
        delta = (m[n] / b1c) / ((v[n] / b2c).sqrt() + opt["eps"])
        if n != "final_norm.scale":
            delta = delta + opt["weight_decay"] * p
        p.sub_(lr * delta)
    return norms


def train_readings(cfg: Dict, seed: int, device, batches: Sequence[Dict],
                   precision: str = "float32") -> Dict:
    """The reference's readings over ``len(batches)`` AdamW steps from the
    seed's weights: each step's loss, each leaf's clipped gradient norm
    at step 1 (``grad1``) and unclipped (``raw1``), and each leaf's
    distance from its start after the last step (``change``)."""
    model = Model(cfg, seed, device, precision)
    out = {"loss": [], "grad1": {}, "raw1": {}, "change": {}}
    with no_tf32():
        params = model.draw()
        for t in params.values():
            t.requires_grad_(True)
        m = {n: torch.zeros_like(t) for n, t in params.items()}
        v = {n: torch.zeros_like(t) for n, t in params.items()}
        for step, batch in enumerate(batches, start=1):
            tokens = torch.as_tensor(batch["tokens"], device=device).long()
            labels = torch.as_tensor(batch["labels"], device=device).long()
            loss = model.loss(params, tokens, labels)
            grads = torch.autograd.grad(loss, list(params.values()))
            grads = dict(zip(params, grads))
            out["loss"].append(float(loss.detach()))
            if step == 1:
                out["raw1"] = {n: float(g.norm()) for n, g in grads.items()}
            norms = adamw(cfg["optimizer"], params, grads, m, v, step)
            if step == 1:
                out["grad1"] = norms
            del grads, loss
        del m, v
        start = Model(cfg, seed, device).draw()
        out["change"] = {n: float((params[n].detach() - start[n]).norm())
                         for n in params}
    return out

