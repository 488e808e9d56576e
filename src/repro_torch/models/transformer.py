"""Model assembly for serving and training: embedding, a stack of blocks,
the final norm and the LM head.

Ported from ``repro/models/transformer.py``: every mixer (``attn``,
``attn_window``, ``mamba``, ``mlstm``, ``slstm``) and FFN (``dense``,
``moe``, ``none``) of the zoo, and the frontends' prefix embeddings
(musicgen-large's audio frames, llava-next-34b's image patches: the
caller passes them, as the JAX package's stubs do). The JAX package
stacks each pattern position's weights over periods and scans over
them; the port holds one ``Block`` module per layer and loops over them,
layer ``p * len(pattern) + j`` being period p's pattern position j.

Entry points:
  init_model(cfg, generator, device, trainable) -> Transformer
  prefill(model, tokens, prefix_embeds)   -> (last_logits, caches)
  decode_step(model, caches, tokens, pos) -> (logits, caches), in place
  init_caches(cfg, batch, cache_len, device) -> caches
  forward_hidden(model, tokens, prefix_embeds) -> (x, (lb, z))
  train_loss(model, batch)                -> nll + 0.01 lb + 0.001 z
  param_specs(cfg)                        -> the JAX parameter tree's leaves
``init_model(cfg, device="meta")`` and ``init_caches(..., device="meta")``
build the model and caches with no storage, for the dry run
(``launch/dryrun.py``). ``models/convert.py::params_from_jax`` builds the model from the JAX
package's weights instead. A served model's weights are cast once, when
it is built, to ``cfg.compute_dtype``; norm scales and the weights the
JAX package reads in float32 (``FLOAT32_WEIGHTS``) stay float32. A model
built with ``trainable=True`` holds them as trainable Parameters in
``cfg.param_dtype`` (norm scales float32), each module casting them to
the compute type where it uses them, as the JAX layers do; with
``cfg.remat`` each block of ``forward_hidden`` is checkpointed
(``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint`` with
nothing saveable), so its activations are recomputed in the backward.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
import torch.nn as nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.kernels.ops import Device, resolve_device
from repro_torch.models import attention, layers, moe, ssm, xlstm
from repro_torch.parallel import ops as pops

Caches = List[Dict]

MIXERS = ("attn", "attn_window", "mamba", "mlstm", "slstm")
FFNS = ("dense", "moe", "none")
FLOAT32_WEIGHTS = layers.FLOAT32_WEIGHTS
AUX_LB_WEIGHT = 0.01       # repro/models/transformer.py's aux weights
AUX_Z_WEIGHT = 0.001


def torch_dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def check_supported(cfg: ModelConfig) -> None:
    """Raise ``ValueError`` for a mixer or FFN the zoo does not have.
    Every frontend is a stub whose prefix embeddings the caller passes
    to ``prefill``."""
    for spec in cfg.pattern:
        if spec.mixer not in MIXERS or spec.ffn not in FFNS:
            raise ValueError(f"{cfg.name}: unknown block {spec}")


def check_prompt_length(cfg: ModelConfig, n: int) -> None:
    """Raise ``ValueError`` unless the recurrent mixers' chunked scans
    take an n-token prompt: up to their chunk, or a multiple of it (the
    JAX package asserts the same rule)."""
    mixers = {spec.mixer for spec in cfg.pattern}
    if "mamba" in mixers:
        ssm.chunk_of(n, ssm.CHUNK)
    if "mlstm" in mixers:
        ssm.chunk_of(n, xlstm.CHUNK)


def recurrent_mixer(cfg: ModelConfig, mixer: str,
                    w: Dict[str, torch.Tensor], **held) -> layers.Mixer:
    """The ``mamba``, ``mlstm`` or ``slstm`` mixer over its weights
    (``held``: the compute type ``cdt`` and ``trainable``)."""
    if mixer == "mamba":
        return layers.Mixer(w, ssm.mamba_forward, ssm.mamba_decode,
                            d_state=cfg.mamba_d_state, **held)
    fns = {"mlstm": (xlstm.mlstm_forward, xlstm.mlstm_decode),
           "slstm": (xlstm.slstm_forward, xlstm.slstm_decode)}[mixer]
    return layers.Mixer(w, *fns, n_heads=cfg.num_heads, **held)


class Block(nn.Module):
    """One layer: its mixer (attention, Mamba, mLSTM or sLSTM), then the
    dense SwiGLU FFN, the MoE FFN when the weights hold ``moe``
    (``models/moe.py``), or no FFN (``ffn == "none"``, no ``norm2``).
    ``cdt``: the compute type the modules cast their weights to at use
    (None when they are held in it); ``trainable``: the weights take
    gradients."""

    def __init__(self, cfg: ModelConfig, spec: BlockSpec,
                 w: Dict[str, torch.Tensor],
                 cdt: Optional[torch.dtype] = None, trainable: bool = False):
        super().__init__()
        held = {"cdt": cdt, "trainable": trainable}
        self.window = spec.window
        self.attends = spec.mixer in ("attn", "attn_window")
        self.norm1 = layers.RMSNorm(w["norm1"], cfg.norm_eps, trainable)
        if self.attends:
            self.mixer = attention.Attention(
                w["wq"], w["wk"], w["wv"], w["wo"], n_heads=cfg.num_heads,
                n_kv=cfg.num_kv_heads, window=spec.window,
                rope_theta=cfg.rope_theta, **held)
        else:
            self.mixer = recurrent_mixer(cfg, spec.mixer, w["mixer"], **held)
        self.norm2 = self.ffn = None
        if "moe" in w:
            self.ffn = moe.MoE(w["moe"], n_experts=cfg.num_experts,
                               top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor, **held)
        elif "wg" in w:
            self.ffn = layers.FFN(w["wg"], w["wu"], w["ffn_wo"], **held)
        if self.ffn is not None:
            self.norm2 = layers.RMSNorm(w["norm2"], cfg.norm_eps, trainable)

    def _ffn(self, x):
        return x if self.ffn is None else x + self.ffn(self.norm2(x))

    def forward(self, x, positions, emit_cache: bool):
        h = self.norm1(x)
        if not self.attends:
            out, cache = self.mixer(h)
            return self._ffn(x + out), cache if emit_cache else None
        out, (k, v) = self.mixer(h, positions)
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
        return self._ffn(x + out), cache

    def train_forward(self, x, positions):
        """Training's forward (``_block_forward`` without a cache): (x,
        lb_loss, z_loss), the MoE aux losses float32 zeros unless the FFN
        is MoE."""
        h = self.norm1(x)
        out = self.mixer(h, positions)[0] if self.attends else \
            self.mixer(h)[0]
        x = x + out
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.ffn is None:
            return x, zero, zero
        h = self.norm2(x)
        if isinstance(self.ffn, moe.MoE):
            out, (lb, z) = self.ffn.forward_aux(h)
            return x + out, lb, z
        return x + self.ffn(h), zero, zero

    def decode(self, x, cache, pos):
        """One token a row; ``cache`` is updated in place (a ring row of
        k, v written, or a recurrent state replaced)."""
        h = self.norm1(x)
        if self.attends:
            out = self.mixer.decode(h, cache, pos)
        else:
            out, new = self.mixer.decode(h, cache)
            cache.update(new)
        return self._ffn(x + out)


class Transformer(nn.Module):
    """The model, served, or trained when ``trainable`` (weights held in
    ``cfg.param_dtype`` as trainable Parameters, cast to the compute type
    at use). ``weights``: float32 tensors in the JAX
    package's layout with the layer axis unstacked and only the real
    query heads: ``embed`` (V, d), ``unembed`` (V, d) unless the config
    ties them, ``final_norm`` (d,), and ``layers``, an iterable of one
    dict a layer, taken one at a time (a layer's float32 draw is cast
    before the next is made): ``norm1`` (d,); for attention ``wq`` (d, H,
    D), ``wk``, ``wv`` (d, KV, D), ``wo`` (H, D, d), else ``mixer`` (the
    weights ``models/ssm.py`` or ``models/xlstm.py`` lists); and unless
    the FFN is ``none``, ``norm2`` (d,) with ``wg``, ``wu`` (d, F),
    ``ffn_wo`` (F, d) for a dense FFN, or ``moe`` for an MoE FFN:
    ``router`` (d, E), ``wg``, ``wu`` (E, d, f), ``wo`` (E, f, d) of the
    E real experts, and optionally ``shared`` (``wg``, ``wu``, ``wo`` of
    a dense SwiGLU)."""

    def __init__(self, cfg: ModelConfig, weights: Dict, device: torch.device,
                 trainable: bool = False):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        cdt = torch_dtype(cfg.compute_dtype)
        # the type the weights are held in, and the one modules cast to
        held = torch_dtype(cfg.param_dtype) if trainable else cdt
        self.cdt = cdt if trainable else None

        def cast(t):
            return t.to(device=device, dtype=held)

        def cast_block(w):
            return {n: (cast_block(t) if isinstance(t, dict) else
                        t.to(device=device, dtype=torch.float32)
                        if n.startswith("norm") or
                        (n in FLOAT32_WEIGHTS and not trainable)
                        else cast(t))
                    for n, t in w.items()}

        self.embed = layers.weight(cast(weights["embed"]), trainable)
        self.unembed = None if cfg.tie_embeddings else \
            layers.weight(cast(weights["unembed"]), trainable)
        blocks = []
        for i, w in enumerate(weights["layers"]):
            blocks.append(Block(cfg, cfg.pattern[i % len(cfg.pattern)],
                                cast_block(w), self.cdt, trainable))
            del w           # freed before the next layer is drawn
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = layers.RMSNorm(
            weights["final_norm"].to(device), cfg.norm_eps, trainable)
        # sqrt(d_model) rounded to the compute type, as the JAX package
        # multiplies a compute-type embedding by a Python float
        self.register_buffer("embed_scale", torch.tensor(
            cfg.d_model ** 0.5, dtype=cdt, device=device), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return layers.embed(tokens, layers.use(self.embed, self.cdt)) * \
            self.embed_scale

    def _table(self) -> torch.Tensor:
        """The LM head's table in the compute type."""
        table = self.embed if self.unembed is None else self.unembed
        return layers.use(table, self.cdt)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        return layers.unembed_logits(x, self._table())

    def decay_mask(self) -> Dict[str, bool]:
        """Which weights AdamW decays, by ``named_parameters`` name: the
        JAX package decays every leaf of two or more dimensions of its
        parameter tree, whose block weights carry a leading layer axis,
        so every block weight (norm scales and biases too) and the
        embedding tables, but not the final norm's scale."""
        return {n: n.startswith("blocks.") or p.dim() >= 2
                for n, p in self.named_parameters()}


def _draw(generator: Optional[torch.Generator], shape,
          scale: Optional[float] = None):
    """``repro/models/layers.py::param``'s distribution: normal times
    1/sqrt(fan_in), fan_in being shape[-2] (shape[-1] for a vector). With
    no generator, an empty ``meta`` tensor: nothing drawn or held."""
    if generator is None:
        return torch.empty(shape, dtype=torch.float32, device="meta")
    if scale is None:
        fan_in = shape[-2] if len(shape) > 1 else shape[-1]
        scale = 1.0 / max(fan_in, 1) ** 0.5
    return torch.randn(shape, generator=generator, device=generator.device,
                       dtype=torch.float32).mul_(scale)


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


def _draw_mixer(cfg: ModelConfig, mixer: str, g: torch.Generator) -> Dict:
    """One layer's Mamba, mLSTM or sLSTM weights with the distributions
    of ``repro/models/ssm.py::init_mamba`` and
    ``repro/models/xlstm.py::init_mlstm`` / ``init_slstm``: conv taps at
    scale 0.5, Mamba's dt bias at 1.0, A_log = log(1..N), ones for D and
    the head norms' scales, zeros for the biases."""
    d, H = cfg.d_model, cfg.num_heads
    dev = g.device if g is not None else torch.device("meta")

    def const(value, *shape):
        return torch.full(shape, value, dtype=torch.float32, device=dev)

    if mixer == "mamba":
        di, N = d * cfg.mamba_expand, cfg.mamba_d_state
        R = cfg.resolved_dt_rank
        a_log = torch.log(torch.arange(1, N + 1, dtype=torch.float32,
                                       device=dev))
        return {"in_proj": _draw(g, (d, 2 * di)),
                "conv_w": _draw(g, (cfg.mamba_d_conv, di), 0.5),
                "conv_b": const(0.0, di),
                "x_proj": _draw(g, (di, R + 2 * N)),
                "dt_w": _draw(g, (R, di)), "dt_b": _draw(g, (di,), 1.0),
                "A_log": a_log.expand(di, N).clone(), "D": const(1.0, di),
                "out_proj": _draw(g, (di, d))}
    if mixer == "mlstm":
        di = d * cfg.mlstm_expand
        return {"w_up": _draw(g, (d, 2 * di)),
                "conv_w": _draw(g, (xlstm.CONV, di), 0.5),
                "conv_b": const(0.0, di),
                "wq": _draw(g, (di, di)), "wk": _draw(g, (di, di)),
                "wv": _draw(g, (di, di)), "w_if": _draw(g, (di, 2 * H)),
                "b_if": const(0.0, 2 * H), "gn_scale": const(1.0, di),
                "w_down": _draw(g, (di, d))}
    dh, ffs = d // H, xlstm.ff_size(d, cfg.slstm_ff_expand)
    return {"w_in": _draw(g, (d, 4 * d)), "b_in": const(0.0, 4 * d),
            "r": _draw(g, (H, dh, 4 * dh)), "gn_scale": const(1.0, d),
            "ff_up": _draw(g, (d, 2 * ffs)), "ff_down": _draw(g, (ffs, d))}


def _draw_layer(cfg: ModelConfig, spec: BlockSpec,
                g: torch.Generator) -> Dict:
    d, kv, hd, f = (cfg.d_model, cfg.num_kv_heads, cfg.resolved_head_dim,
                    cfg.d_ff)
    dev = g.device if g is not None else torch.device("meta")
    w = {"norm1": torch.ones(d, device=dev)}
    if spec.mixer in ("attn", "attn_window"):
        h, hp = cfg.num_heads, attention.padded_heads(cfg.num_heads)
        w.update(wq=_draw(g, (d, hp, hd))[:, :h],
                 wk=_draw(g, (d, kv, hd)), wv=_draw(g, (d, kv, hd)),
                 wo=_draw(g, (hp, hd, d))[:h])
    else:
        w["mixer"] = _draw_mixer(cfg, spec.mixer, g)
    if spec.ffn != "none":
        w["norm2"] = torch.ones(d, device=dev)
    if spec.ffn == "moe":
        w["moe"] = _draw_moe(cfg, g)
    elif spec.ffn == "dense":
        w.update(wg=_draw(g, (d, f)), wu=_draw(g, (d, f)),
                 ffn_wo=_draw(g, (f, d)))
    return w


def _mixer_specs(cfg: ModelConfig, mixer: str):
    """(name, shape, axes, dtype or None for the parameter type) of one
    pattern position's mixer weights, unstacked, as ``repro/models/
    attention.py::init_attention``, ``ssm.py::init_mamba`` and
    ``xlstm.py::init_mlstm`` / ``init_slstm`` build them."""
    d, H = cfg.d_model, cfg.num_heads
    if mixer in ("attn", "attn_window"):
        hp, kv, hd = (attention.padded_heads(H), cfg.num_kv_heads,
                      cfg.resolved_head_dim)
        return [("wq", (d, hp, hd), ("embed", "heads", "head_dim"), None),
                ("wk", (d, kv, hd), ("embed", "kv_heads", "head_dim"), None),
                ("wv", (d, kv, hd), ("embed", "kv_heads", "head_dim"), None),
                ("wo", (hp, hd, d), ("heads", "head_dim", "embed"), None)]
    if mixer == "mamba":
        di, N = d * cfg.mamba_expand, cfg.mamba_d_state
        R = cfg.resolved_dt_rank
        return [("in_proj", (d, 2 * di), ("embed", "ffn"), None),
                ("conv_w", (cfg.mamba_d_conv, di), (None, "ffn"), None),
                ("conv_b", (di,), ("ffn",), None),
                ("x_proj", (di, R + 2 * N), ("ffn", None), None),
                ("dt_w", (R, di), (None, "ffn"), None),
                ("dt_b", (di,), ("ffn",), None),
                ("A_log", (di, N), ("ffn", None), torch.float32),
                ("D", (di,), ("ffn",), None),
                ("out_proj", (di, d), ("ffn", "embed"), None)]
    if mixer == "mlstm":
        di = d * cfg.mlstm_expand
        return [("w_up", (d, 2 * di), ("embed", None), None),
                ("conv_w", (xlstm.CONV, di), (None, None), None),
                ("conv_b", (di,), (None,), None),
                ("wq", (di, di), (None, None), None),
                ("wk", (di, di), (None, None), None),
                ("wv", (di, di), (None, None), None),
                ("w_if", (di, 2 * H), (None, None), None),
                ("b_if", (2 * H,), (None,), None),
                ("gn_scale", (di,), (None,), None),
                ("w_down", (di, d), (None, "embed"), None)]
    dh, ffs = d // H, xlstm.ff_size(d, cfg.slstm_ff_expand)
    return [("w_in", (d, 4 * d), ("embed", None), None),
            ("b_in", (4 * d,), (None,), None),
            ("r", (H, dh, 4 * dh), (None, None, None), None),
            ("gn_scale", (d,), (None,), None),
            ("ff_up", (d, 2 * ffs), ("embed", None), None),
            ("ff_down", (ffs, d), (None, "embed"), None)]


def _ffn_specs(d: int, ff: int):
    return [("wg", (d, ff), ("embed", "ffn"), None),
            ("wu", (d, ff), ("embed", "ffn"), None),
            ("wo", (ff, d), ("ffn", "embed"), None)]


def param_specs(cfg: ModelConfig) -> List[layers.ParamSpec]:
    """Every leaf of the JAX package's parameter tree for ``cfg``, in
    ``jax.tree_util``'s order (dict keys sorted, lists in order): what
    ``split_annotated(init_model(cfg, key))`` gives under
    ``shape_only()`` there, built from the config alone. Block weights
    carry the leading ``layer`` axis of the periods; query heads and
    experts are padded to the JAX package's 16-way axes (the port's own
    weights keep only the real ones)."""
    check_supported(cfg)
    pdt = torch_dtype(cfg.param_dtype)
    d, P = cfg.d_model, cfg.num_periods
    tree: Dict = {"embed": {"table": ((cfg.vocab_size, d),
                                      ("vocab", "embed"), pdt)},
                  "final_norm": {"scale": ((d,), ("embed",), pdt)}}
    if not cfg.tie_embeddings:
        tree["unembed"] = {"table": ((cfg.vocab_size, d),
                                     ("vocab", "embed"), pdt)}

    def stacked(entries):
        return {n: ((P,) + shape, ("layer",) + axes, dt or pdt)
                for n, shape, axes, dt in entries}

    blocks = []
    for spec in cfg.pattern:
        b = {"norm1": stacked([("scale", (d,), ("embed",), None)]),
             "mixer": stacked(_mixer_specs(cfg, spec.mixer))}
        if spec.ffn != "none":
            b["norm2"] = stacked([("scale", (d,), ("embed",), None)])
        if spec.ffn == "dense":
            b["ffn"] = stacked(_ffn_specs(d, cfg.d_ff))
        elif spec.ffn == "moe":
            f, ep = cfg.resolved_d_ff_expert, \
                moe.padded_experts(cfg.num_experts)
            b["ffn"] = stacked([
                ("router", (d, ep), ("embed", None), None),
                ("wg", (ep, d, f), ("expert", "embed", None), None),
                ("wu", (ep, d, f), ("expert", "embed", None), None),
                ("wo", (ep, f, d), ("expert", None, "embed"), None)])
            if cfg.num_shared_experts:
                b["ffn"]["shared"] = stacked(
                    _ffn_specs(d, f * cfg.num_shared_experts))
        blocks.append(b)
    tree["blocks"] = blocks

    out = []

    def walk(node, path):
        if isinstance(node, list):
            for i, child in enumerate(node):
                walk(child, path + (i,))
        elif isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], path + (k,))
        else:
            shape, axes, dt = node
            out.append(layers.ParamSpec(path, tuple(shape), dt,
                                        tuple(axes)))
    walk(tree, ())
    return out


def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device: Device = None, trainable: bool = False) -> Transformer:
    """Random weights with the JAX package's distributions, drawn from
    ``generator`` (a CPU generator seeded 0 if None) on the generator's
    device, then cast to the compute type on ``device`` (the card
    unless the caller asks for the CPU), one layer at a time, so that
    the float32 draws of only one layer are held at once. The padded
    query heads' and experts' weights are drawn and dropped, so each
    weight has the JAX package's scale and the real experts their own
    draws. On ``device="meta"`` (the dry run) nothing is drawn, no
    generator is used and no memory is taken: every weight is an empty
    meta tensor of its shape and type."""
    check_supported(cfg)
    device = resolve_device(device)
    if device.type == "meta":
        g = None
    else:
        g = generator if generator is not None else \
            torch.Generator().manual_seed(0)
    d = cfg.d_model
    weights = {"embed": _draw(g, (cfg.vocab_size, d), 1.0),
               "final_norm": torch.ones(
                   d, device=g.device if g is not None else "meta")}
    if not cfg.tie_embeddings:
        weights["unembed"] = _draw(g, (cfg.vocab_size, d), d ** -0.5)
    weights["layers"] = (_draw_layer(cfg, cfg.pattern[i % len(cfg.pattern)],
                                     g) for i in range(cfg.num_layers))
    return Transformer(cfg, weights, device, trainable)


def forward_hidden(model: Transformer, tokens: torch.Tensor,
                   prefix_embeds: Optional[torch.Tensor] = None):
    """The training forward (``repro/models/transformer.py::
    forward_hidden`` without caches): tokens (B, S), optional prefix
    embeddings (B, P, d) placed before them -> (the final-normed hidden
    states (B, P+S, d), (lb_loss, z_loss) summed over the layers, float32).
    With ``cfg.remat`` and grad enabled each block is checkpointed: its
    forward is run again in the backward, and routes the same tokens to
    the same experts because every forward kernel is bit-reproducible."""
    x = model._embed(tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    lb = z = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = model.cfg.remat and torch.is_grad_enabled()
    for block in model.blocks:
        if remat:
            x, lb_i, z_i = checkpoint(block.train_forward, x, positions,
                                      use_reentrant=False)
        else:
            x, lb_i, z_i = block.train_forward(x, positions)
        lb, z = lb + lb_i, z + z_i
    return model.final_norm(x), (lb, z)


def train_loss(model: Transformer, batch: Dict) -> torch.Tensor:
    """batch: ``tokens`` and ``labels`` (B, S), optional
    ``prefix_embeds`` (B, P, d) -> ``nll + 0.01 lb + 0.001 z``, float32
    (``repro/models/transformer.py::train_loss``): the prefix positions
    are sliced off before the chunked cross-entropy. Under a mesh over
    processes (data-parallel training) the batch is this rank's rows and
    the loss is the global batch's, the same on every rank."""
    prefix = batch.get("prefix_embeds")
    x, (lb, z) = forward_hidden(model, batch["tokens"], prefix)
    npfx = 0 if prefix is None else prefix.shape[1]
    nll = layers.chunked_xent(x[:, npfx:], model._table(), batch["labels"],
                              model.cfg.logit_chunk)
    if pops.data_process_group() is not None:
        # data-parallel: every rank holds as many tokens, so the global
        # mean is the mean of the ranks' means (the aux losses are global
        # already, models/moe.py)
        nll = pops.gather_sum(nll) / pops.data_ranks()
    return nll + AUX_LB_WEIGHT * lb + AUX_Z_WEIGHT * z


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None):
    """tokens (B, S), and a frontend's prefix embeddings (B, P, d) placed
    before them -> (logits of the last position (B, 1, V), caches): one
    a layer, ``{"k", "v"}`` (B, P+S, KV, D) for attention (window layers
    rolled into ring order once P+S exceeds the window), the mixer's
    cache for a recurrent layer (``h`` and ``conv`` for Mamba, ``state``
    and ``conv`` for mLSTM, ``state`` for sLSTM)."""
    x = model._embed(tokens)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    caches = []
    for block in model.blocks:
        x, cache = block(x, positions, emit_cache=True)
        caches.append(cache)
    # the last position of every row, contiguous: the norm's kernel takes
    # contiguous rows (a (B, 1, d) slice of B > 1 rows is not)
    x = model.final_norm(x[:, -1:].contiguous())
    return model._logits(x), caches


@torch.no_grad()
def decode_step(model: Transformer, caches: Caches, tokens: torch.Tensor,
                pos: torch.Tensor):
    """tokens (B, 1); pos (B,) absolute positions (slots may be at
    different depths). Each attention layer's ring cache gets the new k,
    v at row ``pos % S``, each recurrent layer's cache its new state, in
    place; returns (logits (B, 1, V), caches)."""
    pos = pos.to(device=model.device, dtype=torch.int32).reshape(-1)
    x = model._embed(tokens)
    for block, cache in zip(model.blocks, caches):
        x = block.decode(x, cache, pos)
    return model._logits(model.final_norm(x)), caches


def init_caches(cfg: ModelConfig, batch: int, cache_len: int,
                device: Device = None) -> Caches:
    """Zeroed decode caches, one a layer (``prefill``'s leaves at
    ``batch`` rows; attention's k, v at ``cache_len`` ring rows, or the
    window's), recurrent states at their initial values."""
    check_supported(cfg)
    device = resolve_device(device)
    cdt = torch_dtype(cfg.compute_dtype)
    d, H = cfg.d_model, cfg.num_heads
    out = []
    for i in range(cfg.num_layers):
        spec = cfg.pattern[i % len(cfg.pattern)]
        if spec.mixer == "mamba":
            c = ssm.init_mamba_cache(batch, d, d_state=cfg.mamba_d_state,
                                     d_conv=cfg.mamba_d_conv,
                                     expand=cfg.mamba_expand, dtype=cdt,
                                     device=device)
        elif spec.mixer == "mlstm":
            c = xlstm.init_mlstm_cache(batch, d, n_heads=H,
                                       expand=cfg.mlstm_expand, dtype=cdt,
                                       device=device)
        elif spec.mixer == "slstm":
            c = xlstm.init_slstm_cache(batch, d, n_heads=H, device=device)
        else:
            c = attention.init_cache(batch, cache_len, cfg.num_kv_heads,
                                     cfg.resolved_head_dim, spec.window,
                                     cdt, device)
        out.append(c)
    return out
