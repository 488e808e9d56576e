"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA.

32L d_model=3072 24H (GQA kv=8) d_ff=8192 vocab=200064 [arXiv:2412.08905; hf]
"""
from repro_torch.configs.base import BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b",
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=200_064,
        pattern=(BlockSpec(mixer="attn", ffn="dense"),),
        max_seq_len=131_072,
        subquadratic=False,
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=256, max_seq_len=512,
        param_dtype="float32", compute_dtype="float32", remat=False)
