"""Model assembly for serving: embedding, a stack of blocks, the final
norm and the LM head.

Ported from ``repro/models/transformer.py`` for the ``attn`` and
``attn_window`` mixers and the ``dense`` and ``moe`` FFNs, which is what
h2o-danube-1.8b and granite-moe-3b-a800m are built of. The JAX package
stacks each pattern
position's weights over periods and scans over them; the port holds one
``Block`` module per layer and loops over them, layer ``p * len(pattern)
+ j`` being period p's pattern position j.

Entry points:
  init_model(cfg, generator, device)      -> Transformer (random weights)
  prefill(model, tokens)                  -> (last_logits, caches)
  decode_step(model, caches, tokens, pos) -> (logits, caches), in place
  init_caches(cfg, batch, cache_len, device) -> caches
``models/convert.py::params_from_jax`` builds the model from the JAX
package's weights instead. Weights are cast once, when the model is
built, to ``cfg.compute_dtype``; norm scales stay float32.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn as nn

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import Device, resolve_device
from repro_torch.models import attention, layers, moe

Caches = List[Dict[str, torch.Tensor]]

# where the mixers and FFNs this slice does not port are queued
_LATER = {"mamba": "ROADMAP.md §2 item 4 (the missing modules)",
          "mlstm": "ROADMAP.md §2 item 4 (the missing modules)",
          "slstm": "ROADMAP.md §2 item 4 (the missing modules)"}


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` for a block this slice does not
    port, naming the queue item that brings it."""
    for spec in cfg.pattern:
        for part in (spec.mixer, spec.ffn):
            if part in _LATER:
                raise NotImplementedError(
                    f"{cfg.name}: '{part}' blocks are not ported yet; "
                    f"see {_LATER[part]}")
        if spec.mixer not in ("attn", "attn_window") or \
                spec.ffn not in ("dense", "moe"):
            raise ValueError(f"unknown block {spec}")
    if cfg.frontend is not None:
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend} "
                                  "frontend is not ported yet")


class Block(nn.Module):
    """One layer: attention, then the dense SwiGLU FFN, or the MoE FFN
    when the weights hold ``moe`` (``models/moe.py``)."""

    def __init__(self, cfg: ModelConfig, window: Optional[int],
                 w: Dict[str, torch.Tensor]):
        super().__init__()
        self.window = window
        self.norm1 = layers.RMSNorm(w["norm1"], cfg.norm_eps)
        self.mixer = attention.Attention(
            w["wq"], w["wk"], w["wv"], w["wo"], n_heads=cfg.num_heads,
            n_kv=cfg.num_kv_heads, window=window, rope_theta=cfg.rope_theta)
        self.norm2 = layers.RMSNorm(w["norm2"], cfg.norm_eps)
        if "moe" in w:
            self.ffn = moe.MoE(w["moe"], n_experts=cfg.num_experts,
                               top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor)
        else:
            self.ffn = layers.FFN(w["wg"], w["wu"], w["ffn_wo"])

    def forward(self, x, positions, emit_cache: bool):
        out, (k, v) = self.mixer(self.norm1(x), positions)
        cache = None
        if emit_cache:
            w = self.window
            if w is not None and k.shape[1] > w:
                # ring alignment: decode writes at row pos % w, so roll
                # the kept tail such that row r holds position p with
                # r == p % w
                S = k.shape[1]
                k = torch.roll(k[:, -w:], S % w, dims=1)
                v = torch.roll(v[:, -w:], S % w, dims=1)
            cache = {"k": k, "v": v}
        x = x + out
        return x + self.ffn(self.norm2(x)), cache

    def decode(self, x, cache, pos):
        x = x + self.mixer.decode(self.norm1(x), cache, pos)
        return x + self.ffn(self.norm2(x))


class Transformer(nn.Module):
    """The served model. ``weights``: float32 tensors in the JAX
    package's layout with the layer axis unstacked and only the real
    query heads: ``embed`` (V, d), ``unembed`` (V, d) unless the config
    ties them, ``final_norm`` (d,), and per layer ``norm1``, ``norm2``
    (d,), ``wq`` (d, H, D), ``wk``, ``wv`` (d, KV, D), ``wo`` (H, D, d),
    ``wg``, ``wu`` (d, F), ``ffn_wo`` (F, d) for a dense FFN, or ``moe``
    for an MoE FFN: ``router`` (d, E), ``wg``, ``wu`` (E, d, f), ``wo``
    (E, f, d) of the E real experts, and optionally ``shared``
    (``wg``, ``wu``, ``wo`` of a dense SwiGLU)."""

    def __init__(self, cfg: ModelConfig, weights: Dict, device: torch.device):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        cdt = torch_dtype(cfg.compute_dtype)

        def cast(t):
            return t.to(device=device, dtype=cdt)

        def cast_block(w):
            return {n: (cast_block(t) if isinstance(t, dict) else
                        t.to(device=device, dtype=torch.float32)
                        if n.startswith("norm") else cast(t))
                    for n, t in w.items()}

        self.embed = layers.frozen(cast(weights["embed"]))
        self.unembed = None if cfg.tie_embeddings else \
            layers.frozen(cast(weights["unembed"]))
        blocks = []
        for i, w in enumerate(weights["layers"]):
            spec = cfg.pattern[i % len(cfg.pattern)]
            blocks.append(Block(cfg, spec.window, cast_block(w)))
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = layers.RMSNorm(
            weights["final_norm"].to(device), cfg.norm_eps)
        # sqrt(d_model) rounded to the compute type, as the JAX package
        # multiplies a compute-type embedding by a Python float
        self.register_buffer("embed_scale", torch.tensor(
            cfg.d_model ** 0.5, dtype=cdt, device=device), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return layers.embed(tokens, self.embed) * self.embed_scale

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        table = self.embed if self.unembed is None else self.unembed
        return layers.unembed_logits(x, table)


def _draw(generator: torch.Generator, shape, scale: Optional[float] = None):
    """``repro/models/layers.py::param``'s distribution: normal times
    1/sqrt(fan_in), fan_in being shape[-2] (shape[-1] for a vector)."""
    if scale is None:
        fan_in = shape[-2] if len(shape) > 1 else shape[-1]
        scale = 1.0 / max(fan_in, 1) ** 0.5
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=torch.float32) * scale


def _draw_moe(cfg: ModelConfig, g: torch.Generator) -> Dict:
    """One layer's MoE weights: ``repro/models/moe.py::init_moe``'s
    shapes over the padded experts (the fan-in of wg, wu and wo is
    shape[-2], their true fan-in), then the real experts kept."""
    d, f = cfg.d_model, cfg.resolved_d_ff_expert
    ep = moe.padded_experts(cfg.num_experts)
    p = moe.real_experts({"router": _draw(g, (d, ep)),
                          "wg": _draw(g, (ep, d, f)),
                          "wu": _draw(g, (ep, d, f)),
                          "wo": _draw(g, (ep, f, d))}, cfg.num_experts)
    if cfg.num_shared_experts:
        fs = f * cfg.num_shared_experts
        p["shared"] = {"wg": _draw(g, (d, fs)), "wu": _draw(g, (d, fs)),
                       "wo": _draw(g, (fs, d))}
    return p


def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device: Device = None) -> Transformer:
    """Random weights with the JAX package's distributions, drawn from
    ``generator`` (a CPU generator seeded 0 if None) on the generator's
    device, then cast to the compute type on ``device`` (the card
    unless the caller asks for the CPU). The padded query heads' and
    experts' weights are drawn and dropped, so each weight has the JAX
    package's scale and the real experts their own draws."""
    check_supported(cfg)
    device = resolve_device(device)
    g = generator if generator is not None else \
        torch.Generator().manual_seed(0)
    d, h, kv, hd, f = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                       cfg.resolved_head_dim, cfg.d_ff)
    hp = attention.padded_heads(h)
    ones = torch.ones(d, dtype=torch.float32)
    weights = {"embed": _draw(g, (cfg.vocab_size, d), 1.0),
               "final_norm": ones, "layers": []}
    for i in range(cfg.num_layers):
        w = {"norm1": ones, "norm2": ones,
             "wq": _draw(g, (d, hp, hd))[:, :h],
             "wk": _draw(g, (d, kv, hd)), "wv": _draw(g, (d, kv, hd)),
             "wo": _draw(g, (hp, hd, d))[:h]}
        if cfg.pattern[i % len(cfg.pattern)].ffn == "moe":
            w["moe"] = _draw_moe(cfg, g)
        else:
            w.update(wg=_draw(g, (d, f)), wu=_draw(g, (d, f)),
                     ffn_wo=_draw(g, (f, d)))
        weights["layers"].append(w)
    if not cfg.tie_embeddings:
        weights["unembed"] = _draw(g, (cfg.vocab_size, d), d ** -0.5)
    return Transformer(cfg, weights, device)


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor):
    """tokens (B, S) -> (logits of the last position (B, 1, V), caches):
    one ``{"k", "v"}`` per layer, (B, S, KV, D), window layers rolled
    into ring order once S exceeds the window."""
    x = model._embed(tokens)
    positions = torch.arange(x.shape[1], device=x.device)
    caches = []
    for block in model.blocks:
        x, cache = block(x, positions, emit_cache=True)
        caches.append(cache)
    x = model.final_norm(x[:, -1:])
    return model._logits(x), caches


@torch.no_grad()
def decode_step(model: Transformer, caches: Caches, tokens: torch.Tensor,
                pos: torch.Tensor):
    """tokens (B, 1); pos (B,) absolute positions (slots may be at
    different depths). Each layer's ring cache gets the new k, v at row
    ``pos % S``, in place; returns (logits (B, 1, V), caches)."""
    pos = pos.to(device=model.device, dtype=torch.int32).reshape(-1)
    x = model._embed(tokens)
    for block, cache in zip(model.blocks, caches):
        x = block.decode(x, cache, pos)
    return model._logits(model.final_norm(x)), caches


def init_caches(cfg: ModelConfig, batch: int, cache_len: int,
                device: Device = None) -> Caches:
    """Zeroed decode caches, one ``{"k", "v"}`` per layer."""
    check_supported(cfg)
    device = resolve_device(device)
    cdt = torch_dtype(cfg.compute_dtype)
    return [attention.init_cache(batch, cache_len, cfg.num_kv_heads,
                                 cfg.resolved_head_dim,
                                 cfg.pattern[i % len(cfg.pattern)].window,
                                 cdt, device)
            for i in range(cfg.num_layers)]
