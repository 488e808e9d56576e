"""llava-next-34b [vlm] — anyres tiling VLM; transformer backbone only.

60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

The vision tower is a STUB: input_specs() provides precomputed anyres
patch embeddings (num_prefix_embeds x d_model) prepended to the token
sequence, per the assignment's frontend-stub rule.
"""
from repro_torch.configs.base import BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llava-next-34b",
        family="vlm",
        num_layers=60,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        d_ff=20480,
        vocab_size=64000,
        pattern=(BlockSpec(mixer="attn", ffn="dense"),),
        frontend="vision",
        num_prefix_embeds=1024,    # anyres tiling stub (4 tiles + base)
        max_seq_len=32_768,
        subquadratic=False,
    )


def smoke_config() -> ModelConfig:
    return config().scaled(
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, d_ff=128,
        vocab_size=256, num_prefix_embeds=16, max_seq_len=512,
        param_dtype="float32", compute_dtype="float32", remat=False)
