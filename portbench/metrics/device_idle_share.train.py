"""The share of the traced window that no kernel or copy covers, from
the union of the trace's device intervals."""


def read(run):
    s = run.summary
    if s is None or s.busy_s <= 0:
        return None
    return 100.0 * (1.0 - s.busy_s / s.window_s)
