"""The program under test, as the benchmark builds it: a configuration
file turned into the port's ``ModelConfig`` and its model built from the
benchmark's own weights, through the port's public classes. The port
(``repro_torch``) is imported here and in the drivers only, inside the
functions that use it."""
from __future__ import annotations

import math
from typing import Dict

import torch

from portbench import weights as W


def check_as_run(cfg: Dict) -> None:
    """The port has one set of numerics for every configuration: the
    embedding times sqrt(hidden_size), scores times 1/sqrt(head_dim), the
    residual and the logits unscaled. A file whose ``as_run`` states
    others asks for what the port cannot run."""
    run = cfg["as_run"]
    want = {"embedding_multiplier": math.sqrt(cfg["hidden_size"]),
            "attention_multiplier": cfg["head_dim"] ** -0.5,
            "residual_multiplier": 1.0, "logits_scaling": 1.0}
    for k, v in want.items():
        if not math.isclose(run[k], v, rel_tol=1e-12):
            raise ValueError(f"as_run {k} = {run[k]}: the port runs {v}")


def model_config(cfg: Dict):
    """The port's ``ModelConfig`` for a configuration file: the weights
    held in the file's ``train`` types, with its remat."""
    from repro_torch.configs.base import BlockSpec, ModelConfig
    check_as_run(cfg)
    window = cfg.get("sliding_window")
    spec = BlockSpec(mixer="attn_window" if window else "attn",
                     ffn=cfg["ffn"], window=window)
    moe = cfg["ffn"] == "moe"
    return ModelConfig(
        name=cfg["name"], family="moe" if moe else "dense",
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"],
        num_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        head_dim=cfg["head_dim"], pattern=(spec,),
        num_experts=cfg.get("num_local_experts", 0),
        top_k=cfg.get("num_experts_per_tok", 0),
        capacity_factor=cfg["as_run"].get("capacity_factor", 1.25),
        rope_theta=cfg["rope_theta"],
        max_seq_len=cfg["max_position_embeddings"],
        norm_eps=cfg["rms_norm_eps"],
        tie_embeddings=cfg["tie_word_embeddings"],
        logit_chunk=cfg["loss"]["logit_chunk"], **cfg["train"])


def build_model(cfg: Dict, seed: int, device):
    """The port's trainable model over the benchmark's weights for
    ``seed``, held in the file's parameter type."""
    from repro_torch.models.transformer import Transformer, torch_dtype
    mcfg = model_config(cfg)
    weights = W.port_weights(cfg, seed, device, torch_dtype(mcfg.param_dtype))
    return Transformer(mcfg, weights, torch.device(device), trainable=True)
