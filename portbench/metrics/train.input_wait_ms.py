"""Host ms a step in the program's ``train.input`` span: the batch made
into tensors on the card, including any wait for the card's queue that
its copy makes (``program_spans``)."""
from portbench import program_spans as P


def read(run):
    return P.host_ms_per_step(run, "train.input")
