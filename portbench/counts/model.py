"""Model FLOPs from a configuration file's shapes: 2 a multiply-add of
every weight a token passes through (an MoE token its top-k experts and
the router), the output head where logits are needed, and attention's
4·D a kept (query, key) pair of each query head. Training counts 3x
the forward (forward, and a backward of twice its work) and nothing
that remat recomputes."""
from __future__ import annotations

from typing import Dict, Optional

from portbench.counts.kernels import kept_pairs


def layer_params(cfg: Dict) -> int:
    """Weights one token passes through in one layer."""
    d, H, KV, D = (cfg["hidden_size"], cfg["num_attention_heads"],
                   cfg["num_key_value_heads"], cfg["head_dim"])
    F = cfg["intermediate_size"]
    attn = d * H * D + 2 * d * KV * D + H * D * d
    if cfg["ffn"] == "moe":
        E, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
        return attn + d * E + k * 3 * d * F
    return attn + 3 * d * F


def body_params(cfg: Dict) -> int:
    return cfg["num_hidden_layers"] * layer_params(cfg)


def head_params(cfg: Dict) -> int:
    return cfg["vocab_size"] * cfg["hidden_size"]


def active_params(cfg: Dict) -> int:
    """Weights a token passes through, the output head included."""
    return body_params(cfg) + head_params(cfg)


def attention_flops(cfg: Dict, pairs: int) -> int:
    """Forward attention FLOPs of ``pairs`` kept pairs a head, all layers."""
    return 4 * cfg["head_dim"] * cfg["num_attention_heads"] * pairs * \
        cfg["num_hidden_layers"]


def window(cfg: Dict) -> Optional[int]:
    return cfg.get("sliding_window")


def train_flops(cfg: Dict, batch: int, seq: int) -> int:
    """One training step: 6 x the active weights a token, and attention's
    forward and backward (3 x its forward FLOPs)."""
    tokens = batch * seq
    return 6 * active_params(cfg) * tokens + \
        3 * attention_flops(cfg, batch * kept_pairs(seq, seq, window(cfg)))
