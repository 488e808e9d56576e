"""Device ms a step in the program's ``train.remat`` spans: each
checkpointed block's recompute in the backward (``program_spans``)."""
from portbench import program_spans as P


def read(run):
    return P.device_ms_per_step(run, "train.remat")
