"""The training launcher, ported from ``repro/launch/train.py``."""
