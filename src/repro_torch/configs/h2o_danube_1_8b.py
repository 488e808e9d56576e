"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention.

24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000 [arXiv:2401.16818; hf]
"""
from repro_torch.configs.base import BlockSpec, ModelConfig

_WINDOW = 4096  # mistral-style SWA


def config() -> ModelConfig:
    return ModelConfig(
        name="h2o-danube-1.8b",
        family="dense",
        num_layers=24,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        d_ff=6912,
        vocab_size=32000,
        pattern=(BlockSpec(mixer="attn_window", ffn="dense", window=_WINDOW),),
        rope_theta=10_000.0,
        max_seq_len=524_288,
        subquadratic=True,   # SWA => O(window) attention; long_500k runs
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=256, max_seq_len=512,
        pattern=(BlockSpec(mixer="attn_window", ffn="dense", window=32),),
        param_dtype="float32", compute_dtype="float32", remat=False)
