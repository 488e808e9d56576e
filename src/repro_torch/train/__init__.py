"""Training of the LM zoo, ported from ``repro/train``: AdamW, the train
and eval steps, checkpoints, and the JAX-free data pipeline and elastic
policy (copied)."""
