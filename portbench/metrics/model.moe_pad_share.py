"""100 x (1 - rows kept / capacity rows), each summed over the window's
forward dispatches (the program's ``moe.dispatch`` spans outside remat's
recompute, their counts ``kept`` and ``rows``): the capacity rows the
grouped products compute for no token (``program_spans``)."""
from portbench import program_spans as P


def read(run):
    got = P.outside(run, P.named(run, "moe.dispatch"), "train.remat")
    rows = sum(s.counts["rows"] for s in got)
    if not rows:
        return None
    return 100.0 * (1.0 - sum(s.counts["kept"] for s in got) / rows)
