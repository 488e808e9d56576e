"""gemma3-12b [dense] — 5:1 local:global attention interleave, 128k context.

48L d_model=3840 16H (GQA kv=8) d_ff=15360 vocab=262144
[hf:google/gemma-3-1b-pt; unverified]
"""
from repro_torch.configs.base import BlockSpec, ModelConfig

_LOCAL_WINDOW = 1024


def config() -> ModelConfig:
    local = BlockSpec(mixer="attn_window", ffn="dense", window=_LOCAL_WINDOW)
    glob = BlockSpec(mixer="attn", ffn="dense")
    return ModelConfig(
        name="gemma3-12b",
        family="dense",
        num_layers=48,
        d_model=3840,
        num_heads=16,
        num_kv_heads=8,
        d_ff=15360,
        vocab_size=262_144,
        head_dim=256,                      # gemma3 uses wide heads
        pattern=(local, local, local, local, local, glob),  # 5:1
        rope_theta=1_000_000.0,
        max_seq_len=524_288,
        tie_embeddings=True,
        # 40/48 layers are O(window); global layers' *decode* is O(S) per
        # token with a sharded 500k KV. long_500k runs (see DESIGN.md).
        subquadratic=True,
    )


def smoke_config() -> ModelConfig:
    local = BlockSpec(mixer="attn_window", ffn="dense", window=32)
    glob = BlockSpec(mixer="attn", ffn="dense")
    return config().scaled(
        num_layers=6, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        head_dim=16, vocab_size=256, max_seq_len=512,
        pattern=(local, local, local, local, local, glob),
        param_dtype="float32", compute_dtype="float32", remat=False)
