"""Model configurations, copied from ``repro/configs`` (JAX-free
dataclasses) with only their imports rewritten."""
