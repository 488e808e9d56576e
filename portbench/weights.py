"""The benchmark's weights, drawn from ``--seed`` on the device.

Every leaf of a layer comes from one ``torch.randn`` call of the layer's
whole size, on a generator of the device seeded from (seed, layer), so a
layer can be drawn again alone (the reference does, and so does the
train driver when it reads how far each leaf has moved). The leaves are
named as the port's ``named_parameters`` names them, in the layout of
``portbench/reference`` (``mixer.wq`` (d, H, D), ``mixer.wo`` (H, D, d),
an MoE's ``ffn.wg`` (E, d, f)); ``port_weights`` hands the same tensors
to the port's ``Transformer`` in its constructor's layout.

Distributions: every projection N(0, 1/fan_in) at its true fan-in
(``mixer.wo``: H·D), the embedding and an untied output head
N(0, 1/d), so that the port's sqrt(d)-scaled embedding enters the
residual at unit RMS and the logits have unit scale; norm scales 1.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

EMBED = -1          # the layer index of the embedding and output head


def layer_seed(seed: int, layer: int) -> int:
    """A 63-bit seed for one layer's draw (``EMBED`` for the tables)."""
    words = np.random.SeedSequence([seed % 2 ** 64, layer + 1]).generate_state(
        2, np.uint32)
    return (int(words[0]) << 31 | int(words[1]) >> 1) & (2 ** 63 - 1)


def layer_leaves(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    """(name, shape, std) of one layer's drawn leaves, in draw order."""
    d, H, KV = cfg["hidden_size"], cfg["num_attention_heads"], \
        cfg["num_key_value_heads"]
    D, F = cfg["head_dim"], cfg["intermediate_size"]
    out = [("mixer.wq", (d, H, D), d ** -0.5),
           ("mixer.wk", (d, KV, D), d ** -0.5),
           ("mixer.wv", (d, KV, D), d ** -0.5),
           ("mixer.wo", (H, D, d), (H * D) ** -0.5)]
    if cfg["ffn"] == "moe":
        E = cfg["num_local_experts"]
        out += [("ffn.router", (d, E), d ** -0.5),
                ("ffn.wg", (E, d, F), d ** -0.5),
                ("ffn.wu", (E, d, F), d ** -0.5),
                ("ffn.wo", (E, F, d), F ** -0.5)]
    else:
        out += [("ffn.wg", (d, F), d ** -0.5), ("ffn.wu", (d, F), d ** -0.5),
                ("ffn.wo", (F, d), F ** -0.5)]
    return out


def top_leaves(cfg: Dict) -> List[Tuple[str, Tuple[int, ...], float]]:
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    out = [("embed", (V, d), d ** -0.5)]
    if not cfg["tie_word_embeddings"]:
        out.append(("unembed", (V, d), d ** -0.5))
    return out


def _draw(leaves, seed: int, layer: int, device, dtype) -> Dict[str, torch.Tensor]:
    """One randn of the leaves' whole size in float32, each leaf scaled
    to its std and cast to ``dtype`` (a view of the draw in float32)."""
    g = torch.Generator(device=device).manual_seed(layer_seed(seed, layer))
    total = sum(math.prod(s) for _, s, _ in leaves)
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, o = {}, 0
    for name, shape, std in leaves:
        n = math.prod(shape)
        t = flat[o:o + n].view(shape).mul_(std)
        out[name] = t if dtype == torch.float32 else t.to(dtype)
        o += n
    return out


def draw_layer(cfg: Dict, seed: int, layer: int, device,
               dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Layer ``layer``'s leaves (its norm scales included, float32 ones)."""
    w = _draw(layer_leaves(cfg), seed, layer, device, dtype)
    d = cfg["hidden_size"]
    w["norm1.scale"] = torch.ones(d, device=device)
    w["norm2.scale"] = torch.ones(d, device=device)
    return w


def draw_top(cfg: Dict, seed: int, device,
             dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """The embedding, the output head unless tied, the final norm."""
    w = _draw(top_leaves(cfg), seed, EMBED, device, dtype)
    w["final_norm.scale"] = torch.ones(cfg["hidden_size"], device=device)
    return w


def leaf_names(cfg: Dict) -> Iterator[Tuple[str, int, str]]:
    """(the port's parameter name, layer or ``EMBED``, leaf name)."""
    for name, _, _ in top_leaves(cfg):
        yield name, EMBED, name
    yield "final_norm.scale", EMBED, "final_norm.scale"
    for i in range(cfg["num_hidden_layers"]):
        for name in ["norm1.scale", "norm2.scale"] + \
                [n for n, _, _ in layer_leaves(cfg)]:
            yield f"blocks.{i}.{name}", i, name


def port_layer(w: Dict[str, torch.Tensor]) -> Dict:
    """A layer's leaves in the port's ``Transformer`` constructor layout."""
    out = {"norm1": w["norm1.scale"], "norm2": w["norm2.scale"],
           "wq": w["mixer.wq"], "wk": w["mixer.wk"], "wv": w["mixer.wv"],
           "wo": w["mixer.wo"]}
    if "ffn.router" in w:
        out["moe"] = {"router": w["ffn.router"], "wg": w["ffn.wg"],
                      "wu": w["ffn.wu"], "wo": w["ffn.wo"]}
    else:
        out.update(wg=w["ffn.wg"], wu=w["ffn.wu"], ffn_wo=w["ffn.wo"])
    return out


def port_weights(cfg: Dict, seed: int, device, dtype) -> Dict:
    """The weights for ``repro_torch.models.transformer.Transformer``: the
    layers as a generator, drawn one at a time as the constructor takes
    them, in ``dtype`` (the type they are held in)."""
    top = draw_top(cfg, seed, device, dtype)
    weights = {"embed": top["embed"], "final_norm": top["final_norm.scale"]}
    if "unembed" in top:
        weights["unembed"] = top["unembed"]
    weights["layers"] = (port_layer(draw_layer(cfg, seed, i, device, dtype))
                         for i in range(cfg["num_hidden_layers"]))
    return weights
