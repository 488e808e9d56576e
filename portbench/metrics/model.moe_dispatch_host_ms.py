"""Host ms a step in the program's ``moe.dispatch`` and ``moe.combine``
spans, in the forward and in remat's recompute, whose host work is paid
every step too (``program_spans``)."""
from portbench import program_spans as P


def read(run):
    return P.host_ms_per_step(run, "moe.dispatch", "moe.combine")
