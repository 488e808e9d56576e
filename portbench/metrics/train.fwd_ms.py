"""Device ms a step between the events of the program's ``train.fwd``
span: the loss's forward (``program_spans``)."""
from portbench import program_spans as P


def read(run):
    return P.device_ms_per_step(run, "train.fwd")
