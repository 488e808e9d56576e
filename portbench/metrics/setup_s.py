"""From process start to the window's start: import, kernels loaded
from the build cache, weights drawn on the device, the cell's shapes
warmed (host clock)."""


def read(run):
    return run.setup_s
