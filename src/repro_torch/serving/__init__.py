"""The continuous-batching serving engine, ported from
``repro/serving``."""
