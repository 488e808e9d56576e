"""jamba-v0.1-52b [hybrid] — Mamba+attention 1:7 interleave with MoE.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=65536, MoE 16e top-2
[arXiv:2403.19887; hf]

Jamba block structure: each period of 8 layers has 1 attention layer
(index 3 per the paper) and 7 Mamba layers; MoE replaces the dense FFN
on every other layer (e=16, top-2).
"""
from repro_torch.configs.base import BlockSpec, ModelConfig


def config() -> ModelConfig:
    def blk(i):
        mixer = "attn" if i == 3 else "mamba"
        ffn = "moe" if i % 2 == 1 else "dense"
        return BlockSpec(mixer=mixer, ffn=ffn)
    return ModelConfig(
        name="jamba-v0.1-52b",
        family="hybrid",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=14336,
        vocab_size=65536,
        pattern=tuple(blk(i) for i in range(8)),
        num_experts=16,
        top_k=2,
        mamba_d_state=16,
        mamba_d_conv=4,
        mamba_expand=2,
        max_seq_len=524_288,
        subquadratic=True,   # 7/8 layers O(1)-state; attn decode O(S)/token
    )


def smoke_config() -> ModelConfig:
    def blk(i):
        mixer = "attn" if i == 3 else "mamba"
        ffn = "moe" if i % 2 == 1 else "dense"
        return BlockSpec(mixer=mixer, ffn=ffn)
    return config().scaled(
        num_layers=8, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=256, num_experts=4, top_k=2, max_seq_len=512,
        pattern=tuple(blk(i) for i in range(8)),
        param_dtype="float32", compute_dtype="float32", remat=False)
