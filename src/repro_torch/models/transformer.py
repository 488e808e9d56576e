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
  init_model(cfg, generator, device, trainable, mesh) -> Transformer
  prefill(model, tokens, prefix_embeds, cache_len) -> (last_logits, caches)
  decode_step(model, caches, tokens, pos) -> (logits, caches), in place
  init_caches(cfg, batch, cache_len, device, mesh) -> caches
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

The "model" axis. ``init_model(..., mesh=...)`` and ``convert.
params_from_jax(..., mesh=...)`` build one rank's model of a mesh whose
"model" axis is m > 1 (``launch/mesh.make_local_mesh(device, model=m)``):
the same weights as the whole model's, the JAX package's padded heads
and experts kept, each weight cut to the rank's block by the port's
placement (``placement``: ``parallel/sharding.default_rules`` over
``param_specs``; vocab, heads, ffn, experts and Mamba's d_inner over
"model"; the kv heads where ``attention.kv_split``; a dim m does not
divide stays whole and is recorded, ``sharding_fallbacks()``). Such a
model runs under ``parallel/ops.use_mesh`` of that mesh, and its
entry points raise otherwise; its modules call the model axis's
collectives (``parallel/ops.py``) in the same order on every rank, a
rematerialised block's again in the backward. Its decode caches
(``init_caches(..., mesh=...)``, ``prefill``) hold the rank's S/m ring
rows of every kv head and its d_inner slice of a Mamba state. At a
batch of 1 on a data axis of d processes (the JAX placement of
``long_500k``) the batch is whole on every data rank and each
attention ring is split over all d·m ranks, data major: rank (data
d, model c) holds rows ``(d·m + c)·S/(d·m) …`` (``parallel/ops.
serve_placement``), and a tick's partial outputs are merged over all of
them in that order (``attention.py``); a Mamba state is then whole
over "data", as in the JAX ``cache_shardings``. A
parameter replicated over "model" (the norms, the router, a vocab that
falls back) takes the same gradient, and keeps the same bits, on every
model rank.

FSDP over "data". Where the mesh's data axis spans processes (n > 1),
the model is built for the rank's coordinate on it too: every weight
with an "embed" dim (``param_specs``' axes under ``parallel/sharding.
default_rules``, the JAX package's placement) is held as the rank's
slice of that dim, 1/n of it (a dim n does not divide stays whole and
is recorded), and the AdamW moments built over the parameters are
slices with them. A block's slices are gathered (``parallel/ops.
data_gather``, rank order) inside the block's call (``Block.call``:
``torch.func.functional_call`` of the block with its whole weights), so
a rematerialised block gathers again in the backward, as the JAX scan
body does under ``jax.checkpoint``, and the gathered weights live only
inside the call; the backward reduce-scatters each weight's gradient
to the rank's slice in a fixed order. The embedding table, the LM
head's table and the final norm are gathered once a step, outside the
block loop (``whole_top``): a tied table is gathered once and read
twice, so its gradient is reduce-scattered once. A leaf with no
"embed" dim (Mamba's ``conv_w``, ``x_proj``, ``dt_w``, ``A_log``,
``D``; mLSTM's inner ``wq``, ``wk``, ``wv``; sLSTM's ``r``) stays whole
on every data rank, its gradient summed by ``train/train_step.
sum_gradients``. ``split_axes()`` says which axes split each parameter,
for the gradient norm (``train/optimizer.global_norm``) and the
checkpoint (``data_dims``: the dim a parameter is sliced on).
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import torch
import torch.nn as nn
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import BlockSpec, ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.ops import Device, resolve_device
from repro_torch.models import attention, layers, moe, ssm, xlstm
from repro_torch.parallel import ops as pops
from repro_torch.parallel import sharding

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
                    w: Dict[str, torch.Tensor], tp=None,
                    **held) -> layers.Mixer:
    """The ``mamba``, ``mlstm`` or ``slstm`` mixer over its weights
    (``held``: the compute type ``cdt`` and ``trainable``; ``tp``: a
    Mamba's d_inner is split over a model axis)."""
    if mixer == "mamba":
        mix = layers.Mixer(w, ssm.mamba_forward, ssm.mamba_decode,
                           d_state=cfg.mamba_d_state, tp=tp, **held)
        mix.split = {f"w.{n}" for n in w} if tp is not None else set()
        return mix
    fns = {"mlstm": (xlstm.mlstm_forward, xlstm.mlstm_decode),
           "slstm": (xlstm.slstm_forward, xlstm.slstm_decode)}[mixer]
    return layers.Mixer(w, *fns, n_heads=cfg.num_heads, **held)


class Block(nn.Module):
    """One layer: its mixer (attention, Mamba, mLSTM or sLSTM), then the
    dense SwiGLU FFN, the MoE FFN when the weights hold ``moe``
    (``models/moe.py``), or no FFN (``ffn == "none"``, no ``norm2``).
    ``cdt``: the compute type the modules cast their weights to at use
    (None when they are held in it); ``trainable``: the weights take
    gradients. Its entry points (``prefill``, ``train_forward``,
    ``decode``) are run through ``call``, which gathers the weights a
    data axis slices (``data_dims``: name -> dim, set when the model
    slices the block)."""

    def __init__(self, cfg: ModelConfig, spec: BlockSpec,
                 w: Dict[str, torch.Tensor],
                 cdt: Optional[torch.dtype] = None, trainable: bool = False,
                 tps: Optional[Dict[str, layers.TP]] = None):
        super().__init__()
        held = {"cdt": cdt, "trainable": trainable}
        tps = tps or {}
        self.window = spec.window
        self.attends = spec.mixer in ("attn", "attn_window")
        self.norm1 = layers.RMSNorm(w["norm1"], cfg.norm_eps, trainable)
        if self.attends:
            self.mixer = attention.Attention(
                w["wq"], w["wk"], w["wv"], w["wo"], n_heads=cfg.num_heads,
                n_kv=cfg.num_kv_heads, window=spec.window,
                rope_theta=cfg.rope_theta, tp=tps.get("mixer"), **held)
        else:
            self.mixer = recurrent_mixer(cfg, spec.mixer, w["mixer"],
                                         tps.get("mixer"), **held)
        self.norm2 = self.ffn = None
        if "moe" in w:
            self.ffn = moe.MoE(w["moe"], n_experts=cfg.num_experts,
                               top_k=cfg.top_k,
                               capacity_factor=cfg.capacity_factor,
                               tp=tps.get("ffn"), shared_tp=tps.get("shared"),
                               **held)
        elif "wg" in w:
            self.ffn = layers.FFN(w["wg"], w["wu"], w["ffn_wo"],
                                  tp=tps.get("ffn"), **held)
        if self.ffn is not None:
            self.norm2 = layers.RMSNorm(w["norm2"], cfg.norm_eps, trainable)
        self.data_dims: Dict[str, int] = {}

    def call(self, method: str, *args):
        """``method``'s result, with the weights sliced over "data"
        gathered in rank order for this call only."""
        if not self.data_dims:
            return getattr(self, method)(*args)
        whole = {n: pops.data_gather(self.get_parameter(n), d)
                 for n, d in self.data_dims.items()}
        return functional_call(self, whole, (method,) + args)

    def forward(self, method: str, *args):
        """``method`` of the block, the target of ``call``'s
        ``functional_call``."""
        return getattr(self, method)(*args)

    def _ffn(self, x):
        return x if self.ffn is None else x + self.ffn(self.norm2(x))

    def prefill(self, x, positions, emit_cache: bool,
                cache_len: Optional[int] = None):
        h = self.norm1(x)
        if not self.attends:
            out, cache = self.mixer(h)
            return self._ffn(x + out), cache if emit_cache else None
        out, (k, v) = self.mixer(h, positions)
        # ring alignment: decode writes at row pos % S, so the ring's row
        # r holds position p with r == p % S (``attention.ring_part``)
        cache = self.mixer.cache(k, v, cache_len) if emit_cache else None
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


class DataSlice(NamedTuple):
    """A model's place on a "data" axis that slices its weights (FSDP):
    the number of slices and this rank's."""
    size: int
    rank: int


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
                 trainable: bool = False, mesh=None):
        super().__init__()
        check_supported(cfg)
        self.cfg = cfg
        m = 1 if mesh is None else int(mesh.shape.get("model", 1))
        n = 1 if mesh is None else mesh.data_slices
        self.tp = layers.TP(m, mesh.model_rank) if m > 1 else None
        self.fsdp = DataSlice(n, mesh.rank) if n > 1 else None
        place, self.fallbacks = placement(cfg, mesh) \
            if self.tp or self.fsdp else ({}, [])
        # parameter name -> the dim its slice over "data" is cut from
        self.data_dims: Dict[str, int] = {}
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

        def vocab(t, path):
            return _cut(t, place[path], mesh, self.tp) if self.tp else t

        def sliced(mod, prefix, spec_of):
            """``mod``'s weights cut to this rank's slices over "data";
            {name: dim} of those cut."""
            dims = _slice_over_data(mod, spec_of, self.fsdp) \
                if self.fsdp else {}
            self.data_dims.update({prefix + n: d for n, d in dims.items()})
            return dims

        self.vocab_tp = self.tp if self.tp and \
            "model" in place[("embed", "table")] else None
        self.embed = layers.weight(cast(vocab(weights["embed"],
                                              ("embed", "table"))), trainable)
        self.unembed = None if cfg.tie_embeddings else \
            layers.weight(cast(vocab(weights["unembed"],
                                     ("unembed", "table"))), trainable)
        sliced(self, "", lambda n: place[(n, "table")])
        blocks = []
        for i, w in enumerate(weights["layers"]):
            j = i % len(cfg.pattern)
            tps = None
            if self.tp:
                w, tps = _cut_layer(cfg, j, w, place, mesh, self.tp)
            block = Block(cfg, cfg.pattern[j], cast_block(w), self.cdt,
                          trainable, tps)
            del w           # freed before the next layer is drawn
            # the layer axis of the JAX spec dropped
            block.data_dims = sliced(
                block, f"blocks.{i}.",
                lambda n, j=j: place[("blocks", j) + _jax_path(n)][1:])
            blocks.append(block)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = layers.RMSNorm(
            weights["final_norm"].to(device), cfg.norm_eps, trainable)
        sliced(self.final_norm, "final_norm.",
               lambda n: place[("final_norm", n)])
        # sqrt(d_model) rounded to the compute type, as the JAX package
        # multiplies a compute-type embedding by a Python float
        self.register_buffer("embed_scale", torch.tensor(
            cfg.d_model ** 0.5, dtype=cdt, device=device), persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def whole_top(self) -> Dict[str, torch.Tensor]:
        """The embedding table (``embed``), the LM head's table
        (``head``: the same tensor when the config ties them) and the
        final norm's scale (``final_norm``), each gathered once over
        "data" where it is sliced; the parameters themselves otherwise."""
        def whole(name):
            d = self.data_dims.get(name)
            p = self.get_parameter(name)
            return p if d is None else pops.data_gather(p, d)
        embed = whole("embed")
        return {"embed": embed,
                "head": embed if self.unembed is None else whole("unembed"),
                "final_norm": whole("final_norm.scale")}

    def _embed(self, tokens: torch.Tensor, top) -> torch.Tensor:
        table = layers.use(top["embed"], self.cdt)
        if self.vocab_tp is not None:
            return layers.vocab_embed(tokens, table, self.vocab_tp) * \
                self.embed_scale
        return layers.embed(tokens, table) * self.embed_scale

    def _table(self, top) -> torch.Tensor:
        """The LM head's table in the compute type."""
        return layers.use(top["head"], self.cdt)

    def _final_norm(self, x: torch.Tensor, top) -> torch.Tensor:
        return ops.rmsnorm(x, top["final_norm"], self.final_norm.eps)

    def _logits(self, x: torch.Tensor, top) -> torch.Tensor:
        """The whole vocab's logits, gathered in rank order where the
        vocab is split over a model axis (every rank samples alike)."""
        logits = layers.unembed_logits(x, self._table(top))
        if self.vocab_tp is not None:
            logits = pops.model_gather(logits, dim=-1)
        return logits

    def check_axis(self) -> None:
        """Raise unless the installed mesh's model and data axes are the
        ones this model was built for (one rank's weights run only under
        them)."""
        m, r = self.tp if self.tp else (1, 0)
        if pops.model_size() != m or (m > 1 and pops.model_rank() != r):
            raise ValueError(f"the model was built for rank {r} of a model "
                             f"axis of {m}; the installed mesh is rank "
                             f"{pops.model_rank()} of {pops.model_size()}: "
                             "run it under parallel/ops.use_mesh of its "
                             "mesh")
        n, q = self.fsdp if self.fsdp else (1, 0)
        if n > 1 and (pops.data_slices() != n or pops.data_rank() != q):
            raise ValueError(f"the model was built for slice {q} of a data "
                             f"axis of {n}; the installed mesh is rank "
                             f"{pops.data_rank()} of {pops.data_slices()}: "
                             "run it under parallel/ops.use_mesh of its "
                             "mesh")

    def slice_of(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of ``t``, a whole tensor of parameter
        ``name``'s shape (its gradient, a moment, a checkpoint's leaf):
        the slice over "data" the parameter holds, ``t`` itself where it
        is whole. A view of ``t``."""
        d = self.data_dims.get(name)
        if d is None:
            return t
        size = t.shape[d] // self.fsdp.size
        return t.narrow(d, self.fsdp.rank * size, size)

    def split_axes(self) -> Dict[str, tuple]:
        """The mesh axes each parameter is split over, by
        ``named_parameters`` name: ``("data",)``, ``("model",)``, both,
        or ``()`` (whole on every rank of the mesh)."""
        split = set()
        for prefix, mod in self.named_modules():
            for n in getattr(mod, "split", ()):
                split.add(f"{prefix}.{n}" if prefix else n)
        if self.vocab_tp is not None:
            split |= {"embed", "unembed"}
        return {n: ("data",) * (n in self.data_dims) +
                ("model",) * (n in split)
                for n, _ in self.named_parameters()}

    def sharding_fallbacks(self) -> list:
        """The dims the model or data axis does not divide, kept whole
        (``parallel/sharding.explain_fallbacks``)."""
        return sharding.explain_fallbacks(self.fallbacks)

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


def _draw_moe(cfg: ModelConfig, g: torch.Generator,
              padded: bool = False) -> Dict:
    """One layer's MoE weights: ``repro/models/moe.py::init_moe``'s
    shapes over the padded experts (the fan-in of wg, wu and wo is
    shape[-2], their true fan-in), then the real experts kept (all of
    them kept when ``padded``)."""
    d, f = cfg.d_model, cfg.resolved_d_ff_expert
    ep = moe.padded_experts(cfg.num_experts)
    p = {"router": _draw(g, (d, ep)), "wg": _draw(g, (ep, d, f)),
         "wu": _draw(g, (ep, d, f)), "wo": _draw(g, (ep, f, d))}
    if not padded:
        p = moe.real_experts(p, cfg.num_experts)
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
                g: torch.Generator, padded: bool = False) -> Dict:
    """One layer's weights; ``padded``: the JAX package's padded query
    heads and experts kept (a model axis's layout)."""
    d, kv, hd, f = (cfg.d_model, cfg.num_kv_heads, cfg.resolved_head_dim,
                    cfg.d_ff)
    dev = g.device if g is not None else torch.device("meta")
    w = {"norm1": torch.ones(d, device=dev)}
    if spec.mixer in ("attn", "attn_window"):
        h, hp = cfg.num_heads, attention.padded_heads(cfg.num_heads)
        keep = hp if padded else h
        w.update(wq=_draw(g, (d, hp, hd))[:, :keep],
                 wk=_draw(g, (d, kv, hd)), wv=_draw(g, (d, kv, hd)),
                 wo=_draw(g, (hp, hd, d))[:keep])
    else:
        w["mixer"] = _draw_mixer(cfg, spec.mixer, g)
    if spec.ffn != "none":
        w["norm2"] = torch.ones(d, device=dev)
    if spec.ffn == "moe":
        w["moe"] = _draw_moe(cfg, g, padded)
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


def placement(cfg: ModelConfig, mesh):
    """The port's placement of ``cfg``'s weights over ``mesh``: {JAX
    path: spec} (``param_specs``' paths, the specs of ``parallel/
    sharding.param_shardings`` under ``default_rules``: "embed" over
    "data", the rest over "model", the kv heads replicated over "model"
    where ``attention.kv_split`` is false), and the fallback records."""
    m = int(mesh.shape.get("model", 1))
    fallbacks: list = []
    specs = param_specs(cfg)
    placed = sharding.param_shardings(specs, mesh,
                                      sharding.default_rules(mesh), fallbacks)
    out = {}
    kv_whole = m > 1 and not attention.kv_split(cfg.num_heads,
                                                cfg.num_kv_heads, m)
    for p, spec in zip(specs, placed):
        if p.path[-1] in ("wk", "wv") and "kv_heads" in p.axes and \
                kv_whole and "model" in spec:
            spec = tuple(None if e == "model" else e for e in spec)
            fallbacks.append(("kv_heads", cfg.num_kv_heads, ("model",)))
        out[p.path] = spec
    return out, fallbacks


def _jax_path(name: str) -> tuple:
    """The JAX path under a block of a block's parameter ``name``
    (``mixer.w.in_proj`` -> ``("mixer", "in_proj")``)."""
    parts = name.split(".")
    if parts[:2] == ["mixer", "w"]:
        parts = ["mixer"] + parts[2:]
    return tuple(parts)


def _data_dim(spec, ndim: int) -> Optional[int]:
    """The dim of the port's weight (``ndim`` dims) that the JAX ``spec``
    slices over "data", or None. The port holds the JAX layout but for
    attention's heads, flattened with the head dim; the "embed" dim is
    then the first or the last."""
    k = len(spec)
    for i, e in enumerate(spec):
        if e is not None and "data" in ((e,) if isinstance(e, str) else e):
            if ndim == k or i == 0:
                return i
            if i == k - 1:
                return ndim - 1
            raise ValueError(f"no port dim for dim {i} of {spec}")
    return None


def _slice_over_data(mod: nn.Module, spec_of,
                     fsdp: DataSlice) -> Dict[str, int]:
    """Each parameter of ``mod`` whose JAX spec (``spec_of(name)``)
    splits a dim over "data" replaced by this rank's slice of it (a
    tensor of its own; the whole freed); returns {name: dim}."""
    dims = {}
    for name, p in list(mod.named_parameters()):
        dim = _data_dim(spec_of(name), p.dim())
        if dim is None:
            continue
        owner, _, attr = name.rpartition(".")
        size = p.shape[dim] // fsdp.size
        cut = p.detach().narrow(dim, fsdp.rank * size, size).clone(
            memory_format=torch.contiguous_format)
        setattr(mod.get_submodule(owner), attr,
                nn.Parameter(cut, requires_grad=p.requires_grad))
        dims[name] = dim
    return dims


def _cut(t: torch.Tensor, spec, mesh, tp: layers.TP) -> torch.Tensor:
    """This rank's block of ``t`` by ``spec``, a tensor of its own."""
    return sharding.local_shard(t, spec, mesh, {"model": tp.rank}).clone(
        memory_format=torch.contiguous_format)


def _cut_layer(cfg: ModelConfig, j: int, w: Dict, place, mesh,
               tp: layers.TP):
    """Pattern position j's layer weights ``w`` (padded heads and
    experts, the JAX layout unstacked) cut to this rank's blocks, and the
    model axis of each of its modules that is split ({"mixer", "ffn",
    "shared"} -> TP)."""
    blk = ("blocks", j)

    def spec(*path):
        return place[blk + path][1:]          # the layer axis dropped

    def cut(t, *path):
        return _cut(t, spec(*path), mesh, tp)

    def split(*path):
        return "model" in spec(*path)

    out, tps = dict(w), {}
    if "mixer" in w:
        mix = dict(w["mixer"])
        if "in_proj" in mix:                  # Mamba: [x | z], each cut
            half = mix["in_proj"].shape[-1] // 2
            mix["in_proj"] = torch.cat(
                [cut(t, "mixer", "in_proj") for t in
                 mix["in_proj"].split(half, dim=-1)], dim=-1)
        for n in mix:
            if n != "in_proj":
                mix[n] = cut(mix[n], "mixer", n)
        out["mixer"] = mix
        if "in_proj" in mix and split("mixer", "conv_b"):
            tps["mixer"] = tp
    else:
        for n in ("wq", "wk", "wv", "wo"):
            out[n] = cut(w[n], "mixer", n)
        if split("mixer", "wq"):
            tps["mixer"] = tp
    if "wg" in w:
        out.update(wg=cut(w["wg"], "ffn", "wg"), wu=cut(w["wu"], "ffn", "wu"),
                   ffn_wo=cut(w["ffn_wo"], "ffn", "wo"))
        if split("ffn", "wg"):
            tps["ffn"] = tp
    if "moe" in w:
        e = dict(w["moe"])
        e["router"] = e["router"][:, :cfg.num_experts].clone()
        for n in ("wg", "wu", "wo"):
            e[n] = cut(e[n], "ffn", n)
        if split("ffn", "wg"):
            tps["ffn"] = tp
        if "shared" in e:
            e["shared"] = {n: cut(t, "ffn", "shared", n)
                           for n, t in e["shared"].items()}
            if split("ffn", "shared", "wg"):
                tps["shared"] = tp
        out["moe"] = e
    return out, tps


def init_model(cfg: ModelConfig, generator: Optional[torch.Generator] = None,
               device: Device = None, trainable: bool = False,
               mesh=None) -> Transformer:
    """Random weights with the JAX package's distributions, drawn from
    ``generator`` (a CPU generator seeded 0 if None) on the generator's
    device, then cast to the compute type on ``device`` (the card
    unless the caller asks for the CPU), one layer at a time, so that
    the float32 draws of only one layer are held at once. The padded
    query heads' and experts' weights are drawn and dropped, so each
    weight has the JAX package's scale and the real experts their own
    draws. On ``device="meta"`` (the dry run) nothing is drawn, no
    generator is used and no memory is taken: every weight is an empty
    meta tensor of its shape and type. ``mesh``: build this rank's model
    of the mesh's "model" axis (the module's docstring): the same draws,
    each weight cut to the rank's block."""
    check_supported(cfg)
    device = resolve_device(device)
    padded = mesh is not None and int(mesh.shape.get("model", 1)) > 1
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
                                     g, padded)
                         for i in range(cfg.num_layers))
    return Transformer(cfg, weights, device, trainable, mesh)


def forward_hidden(model: Transformer, tokens: torch.Tensor,
                   prefix_embeds: Optional[torch.Tensor] = None, top=None):
    """The training forward (``repro/models/transformer.py::
    forward_hidden`` without caches): tokens (B, S), optional prefix
    embeddings (B, P, d) placed before them -> (the final-normed hidden
    states (B, P+S, d), (lb_loss, z_loss) summed over the layers, float32).
    With ``cfg.remat`` and grad enabled each block is checkpointed: its
    forward (its weights' gathers over "data" included) is run again in
    the backward, and routes the same tokens to the same experts because
    every forward kernel is bit-reproducible. ``top``: the model's
    ``whole_top()``, taken here when None."""
    model.check_axis()
    top = model.whole_top() if top is None else top
    x = model._embed(tokens, top)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    lb = z = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = model.cfg.remat and torch.is_grad_enabled()
    for block in model.blocks:
        if remat:
            x, lb_i, z_i = checkpoint(block.call, "train_forward", x,
                                      positions, use_reentrant=False)
        else:
            x, lb_i, z_i = block.call("train_forward", x, positions)
        lb, z = lb + lb_i, z + z_i
    return model._final_norm(x, top), (lb, z)


def train_loss(model: Transformer, batch: Dict) -> torch.Tensor:
    """batch: ``tokens`` and ``labels`` (B, S), optional
    ``prefix_embeds`` (B, P, d) -> ``nll + 0.01 lb + 0.001 z``, float32
    (``repro/models/transformer.py::train_loss``): the prefix positions
    are sliced off before the chunked cross-entropy. Under a mesh over
    processes (data-parallel training) the batch is this rank's rows and
    the loss is the global batch's, the same on every rank."""
    prefix = batch.get("prefix_embeds")
    model.check_axis()
    top = model.whole_top()
    x, (lb, z) = forward_hidden(model, batch["tokens"], prefix, top)
    npfx = 0 if prefix is None else prefix.shape[1]
    nll = layers.chunked_xent(x[:, npfx:], model._table(top),
                              batch["labels"], model.cfg.logit_chunk,
                              model.vocab_tp)
    if pops.data_ranks() > 1:
        # data-parallel: every rank holds as many tokens, so the global
        # mean is the mean of the ranks' means (the aux losses are global
        # already, models/moe.py)
        nll = pops.gather_sum(nll) / pops.data_ranks()
    return nll + AUX_LB_WEIGHT * lb + AUX_Z_WEIGHT * z


@torch.no_grad()
def prefill(model: Transformer, tokens: torch.Tensor,
            prefix_embeds: Optional[torch.Tensor] = None,
            cache_len: Optional[int] = None):
    """tokens (B, S), and a frontend's prefix embeddings (B, P, d) placed
    before them -> (logits of the last position (B, 1, V), caches): one
    a layer, ``{"k", "v"}`` (B, P+S, KV, D) for attention (window layers
    rolled into ring order once P+S exceeds the window), the mixer's
    cache for a recurrent layer (``h`` and ``conv`` for Mamba, ``state``
    and ``conv`` for mLSTM, ``state`` for sLSTM). ``cache_len``: the
    attention caches as rings of that many rows (``init_caches``'),
    position p at row p % S. Over a cache axis (``parallel/ops.
    cache_size``: the model axis, or ("data", "model") where the step
    serves a batch of 1) each attention cache is this rank's rows of its
    ring, every kv head."""
    model.check_axis()
    top = model.whole_top()
    x = model._embed(tokens, top)
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    caches = []
    for block in model.blocks:
        x, cache = block.call("prefill", x, positions, True, cache_len)
        caches.append(cache)
    # the last position of every row, contiguous: the norm's kernel takes
    # contiguous rows (a (B, 1, d) slice of B > 1 rows is not)
    x = model._final_norm(x[:, -1:].contiguous(), top)
    return model._logits(x, top), caches


@torch.no_grad()
def decode_step(model: Transformer, caches: Caches, tokens: torch.Tensor,
                pos: torch.Tensor):
    """tokens (B, 1); pos (B,) absolute positions (slots may be at
    different depths). Each attention layer's ring cache gets the new k,
    v at row ``pos % S``, each recurrent layer's cache its new state, in
    place; returns (logits (B, 1, V), caches)."""
    model.check_axis()
    _check_rings(model, caches, tokens.shape[0])
    pos = pos.to(device=model.device, dtype=torch.int32).reshape(-1)
    top = model.whole_top()
    x = model._embed(tokens, top)
    for block, cache in zip(model.blocks, caches):
        x = block.call("decode", x, cache, pos)
    return model._logits(model._final_norm(x, top), top), caches


def _check_rings(model: Transformer, caches: Caches, rows: int) -> None:
    """Raise where the attention caches are not this rank's part of the
    rings that the installed step places (``parallel/ops.
    serve_placement``): ``rows`` rows, and over its cache axis of n
    ranks, S/n ring rows of every global layer and min(S, window)/n of a
    window layer, for one S."""
    n = pops.cache_size()
    rings = [(block.mixer.window, c["k"].shape)
             for block, c in zip(model.blocks, caches) if block.attends]
    full = {shape[1] * n for w, shape in rings if w is None}
    S = max(full) if full else None
    for w, shape in rings:
        ring = shape[1] * n
        want = S if w is None else min(ring if S is None else S, w)
        if len(full) > 1 or ring != want or shape[0] != rows:
            raise ValueError(
                f"the caches' rings {[tuple(sh[:2]) for _, sh in rings]} "
                f"are not a rank's part of rings placed for {rows} rows "
                f"over a cache axis of {n} ranks")


def init_caches(cfg: ModelConfig, batch: int, cache_len: int,
                device: Device = None, mesh=None) -> Caches:
    """Zeroed decode caches, one a layer (``prefill``'s leaves at
    ``batch`` rows; attention's k, v at ``cache_len`` ring rows, or the
    window's), recurrent states at their initial values. ``mesh``: this
    rank's caches of a step serving a global ``batch`` over the mesh
    (``parallel/ops.serve_placement``: its rows of the batch, its rows of
    each ring over the cache axis, the model axis or at a batch of 1
    ("data", "model"); its d_inner slice of a Mamba state where d_inner
    divides)."""
    check_supported(cfg)
    device = resolve_device(device)
    cdt = torch_dtype(cfg.compute_dtype)
    d, H = cfg.d_model, cfg.num_heads
    m = 1 if mesh is None else int(mesh.shape.get("model", 1))
    batch, axis = pops.serve_placement(mesh, batch)
    di_split = m if m > 1 and (d * cfg.mamba_expand) % m == 0 else 1
    out = []
    for i in range(cfg.num_layers):
        spec = cfg.pattern[i % len(cfg.pattern)]
        if spec.mixer == "mamba":
            c = ssm.init_mamba_cache(batch, d, d_state=cfg.mamba_d_state,
                                     d_conv=cfg.mamba_d_conv,
                                     expand=cfg.mamba_expand, dtype=cdt,
                                     device=device, split=di_split)
        elif spec.mixer == "mlstm":
            c = xlstm.init_mlstm_cache(batch, d, n_heads=H,
                                       expand=cfg.mlstm_expand, dtype=cdt,
                                       device=device)
        elif spec.mixer == "slstm":
            c = xlstm.init_slstm_cache(batch, d, n_heads=H, device=device)
        else:
            c = attention.init_cache(batch, cache_len, cfg.num_kv_heads,
                                     cfg.resolved_head_dim, spec.window,
                                     cdt, device, axis)
        out.append(c)
    return out
