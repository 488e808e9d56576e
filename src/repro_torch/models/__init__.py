"""The LM zoo's dense transformer, ported from ``repro/models``."""
