"""xlstm-125m [ssm] — sLSTM + mLSTM blocks (xLSTM[7:1]-style interleave).

12L d_model=768 4H (GQA kv=4) d_ff=0 vocab=50304 [arXiv:2405.04517]

d_ff=0: xLSTM blocks fold their projections into the block itself
(mLSTM: pre-up-projection x2; sLSTM: post-FFN x4/3), per the paper.
"""
from repro_torch.configs.base import BlockSpec, ModelConfig


def config() -> ModelConfig:
    m = BlockSpec(mixer="mlstm", ffn="none")
    s = BlockSpec(mixer="slstm", ffn="none")
    return ModelConfig(
        name="xlstm-125m",
        family="ssm",
        num_layers=12,
        d_model=768,
        num_heads=4,
        num_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        pattern=(m, m, m, m, m, s),   # 5:1 within each 6-block period (x2)
        max_seq_len=524_288,
        tie_embeddings=True,
        subquadratic=True,            # O(1) recurrent state
    )


def smoke_config() -> ModelConfig:
    m = BlockSpec(mixer="mlstm", ffn="none")
    s = BlockSpec(mixer="slstm", ffn="none")
    return config().scaled(
        num_layers=6, d_model=64, num_heads=2, num_kv_heads=2,
        vocab_size=256, max_seq_len=512, pattern=(m, m, m, m, m, s),
        param_dtype="float32", compute_dtype="float32", remat=False)
