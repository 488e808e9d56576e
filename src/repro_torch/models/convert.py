"""The JAX package's weights, carried into the port's model.

``params_from_jax(cfg, tree)`` takes the parameter tree of
``repro.models.transformer.init_model`` as NumPy arrays, after
``layers.split_annotated(...)[0]``: each pattern position's weights are
stacked over periods on a leading ``layer`` axis, and the query heads
are padded to the JAX package's tensor-parallel multiple. It unstacks the
layer axis (layer ``p * len(pattern) + j`` is period p's position j) and
keeps only the real query heads, whose padded partners the JAX model
masks to exactly zero. Mamba, mLSTM and sLSTM mixers have no padded
heads and carry across whole; blocks whose FFN is ``none`` have no
``norm2`` and no ``ffn``. An MoE FFN keeps its first ``num_experts``
experts and router columns, the JAX package's padded experts being
dead (never routed to); the tree must hold ``padded_experts`` of them.
``trainable=True`` builds the model for training (``Transformer``); the
dropped padded heads and experts take exactly zero gradient in the JAX
package, so their absence changes no gradient of a kept weight.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ops import Device, resolve_device
from repro_torch.models import attention, moe
from repro_torch.models.transformer import Transformer, check_supported


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def params_from_jax(cfg: ModelConfig, tree: Mapping,
                    device: Device = None,
                    trainable: bool = False) -> Transformer:
    check_supported(cfg)
    device = resolve_device(device)
    h = cfg.num_heads
    hp = attention.padded_heads(h)
    n_pat = len(cfg.pattern)
    weights = {"embed": _t(tree["embed"]["table"]),
               "final_norm": _t(tree["final_norm"]["scale"]), "layers": []}
    if not cfg.tie_embeddings:
        weights["unembed"] = _t(tree["unembed"]["table"])
    for i in range(cfg.num_layers):
        p, j = divmod(i, n_pat)
        spec, blk = cfg.pattern[j], tree["blocks"][j]
        mix = blk["mixer"]
        w = {"norm1": _t(blk["norm1"]["scale"][p])}
        if spec.mixer in ("attn", "attn_window"):
            if np.shape(mix["wq"])[-2] != hp:
                raise ValueError(f"wq has {np.shape(mix['wq'])[-2]} heads; "
                                 f"the JAX package pads {h} to {hp}")
            w.update(wq=_t(mix["wq"][p][:, :h]), wk=_t(mix["wk"][p]),
                     wv=_t(mix["wv"][p]), wo=_t(mix["wo"][p][:h]))
        else:
            w["mixer"] = {n: _t(a[p]) for n, a in mix.items()}
        if spec.ffn != "none":
            ffn = blk["ffn"]
            w["norm2"] = _t(blk["norm2"]["scale"][p])
        if spec.ffn == "moe":
            w["moe"] = moe.real_experts(
                {n: _t(ffn[n][p]) for n in ("router", "wg", "wu", "wo")},
                cfg.num_experts)
            if "shared" in ffn:
                w["moe"]["shared"] = {n: _t(ffn["shared"][n][p])
                                      for n in ("wg", "wu", "wo")}
        elif spec.ffn == "dense":
            w.update(wg=_t(ffn["wg"][p]), wu=_t(ffn["wu"][p]),
                     ffn_wo=_t(ffn["wo"][p]))
        weights["layers"].append(w)
    return Transformer(cfg, weights, device, trainable)
