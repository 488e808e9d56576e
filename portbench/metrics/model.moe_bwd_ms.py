"""Device self time a step of the program's ``moe.bwd`` spans (the MoE
FFN's backward, from its output's gradient to its input's): each less
the ``train.remat`` recompute it holds (``program_spans``)."""
from portbench import program_spans as P


def read(run):
    return P.device_ms_per_step(run, "moe.bwd", less="train.remat")
