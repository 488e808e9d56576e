"""musicgen-large [audio] — decoder-only transformer over EnCodec tokens.

48L d_model=2048 32H (GQA kv=32, i.e. MHA) d_ff=8192 vocab=2048
[arXiv:2306.05284; hf]

Backbone only: the EnCodec frontend is a STUB — input_specs() provides
precomputed frame embeddings via the audio frontend hook.
"""
from repro_torch.configs.base import BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="musicgen-large",
        family="audio",
        num_layers=48,
        d_model=2048,
        num_heads=32,
        num_kv_heads=32,          # MHA
        d_ff=8192,
        vocab_size=2048,          # EnCodec codebook
        pattern=(BlockSpec(mixer="attn", ffn="dense"),),
        frontend="audio",
        max_seq_len=32_768,
        subquadratic=False,
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=4, d_ff=128,
        vocab_size=128, max_seq_len=512,
        param_dtype="float32", compute_dtype="float32", remat=False)
