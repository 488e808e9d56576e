"""granite-20b [dense] — llama-arch code model with MQA (kv=1).

52L d_model=6144 48H (GQA kv=1) d_ff=24576 vocab=49152 [arXiv:2405.04324; hf]
"""
from repro_torch.configs.base import BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-20b",
        family="dense",
        num_layers=52,
        d_model=6144,
        num_heads=48,
        num_kv_heads=1,        # MQA
        d_ff=24576,
        vocab_size=49152,
        pattern=(BlockSpec(mixer="attn", ffn="dense"),),
        max_seq_len=32_768,
        subquadratic=False,    # pure full attention: long_500k skipped
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=1, d_ff=128,
        vocab_size=256, max_seq_len=512,
        param_dtype="float32", compute_dtype="float32", remat=False)
