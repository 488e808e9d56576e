"""llama4-maverick-400b-a17b [moe] — MoE top-1 + shared expert, early fusion.

48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]

Maverick interleaves dense and MoE FFN layers 1:1 (128 routed experts +
1 shared expert on MoE layers), which is what reconciles 400B total with
17B active at the assigned dims.
"""
from repro_torch.configs.base import BlockSpec, ModelConfig


def config() -> ModelConfig:
    dense = BlockSpec(mixer="attn", ffn="dense")
    moe = BlockSpec(mixer="attn", ffn="moe")
    return ModelConfig(
        name="llama4-maverick-400b-a17b",
        family="moe",
        num_layers=48,
        d_model=5120,
        num_heads=40,
        num_kv_heads=8,
        d_ff=8192,
        vocab_size=202_048,
        pattern=(dense, moe),       # 1:1 dense:moe interleave
        num_experts=128,
        top_k=1,
        num_shared_experts=1,
        rope_theta=500_000.0,
        max_seq_len=131_072,
        param_dtype="bfloat16",     # 400B: fp32 params would not fit 512xv5e
        subquadratic=False,         # assigned config: full GQA (no iRoPE chunking)
    )


def smoke_config() -> ModelConfig:
    dense = BlockSpec(mixer="attn", ffn="dense")
    moe = BlockSpec(mixer="attn", ffn="moe")
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=256, num_experts=4, top_k=1, num_shared_experts=1,
        pattern=(dense, moe), max_seq_len=512,
        param_dtype="float32", compute_dtype="float32", remat=False)
