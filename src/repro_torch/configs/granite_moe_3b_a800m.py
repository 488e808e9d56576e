"""granite-moe-3b-a800m [moe] — fine-grained MoE, top-8.

32L d_model=1536 24H (GQA kv=8) d_ff=512 vocab=49155, MoE 40e top-8
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

Note: the assignment lists "MoE 40e top-8" in the spec field and "32
experts" in the prose note; we follow the spec field (40 experts, top-8).
"""
from repro_torch.configs.base import BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-3b-a800m",
        family="moe",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        d_ff=512,                 # per-expert hidden (fine-grained experts)
        vocab_size=49155,
        pattern=(BlockSpec(mixer="attn", ffn="moe"),),
        num_experts=40,
        top_k=8,
        max_seq_len=131_072,
        subquadratic=False,
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=32,
        vocab_size=256, num_experts=8, top_k=2, max_seq_len=512,
        param_dtype="float32", compute_dtype="float32", remat=False)
