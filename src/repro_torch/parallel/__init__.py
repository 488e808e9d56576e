"""Meshes, sharding rules and data-parallel sums, ported from
``repro/parallel``."""
