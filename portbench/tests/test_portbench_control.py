"""The control of every cell comes out not correct: the plain reference
in fp8 (every product's inputs, forward and backward) put in the
program's place, read at the cell's own size against the cell's limits.
On the card only (the cells' own sizes); ``calibrate.py --control N``
reads the same over many seeds."""
import time

import pytest

from portbench import harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, card):
    keep = []
    res = harness.execute(cell, 2 ** 32 + 1234567, 6.0, False, card,
                          time.perf_counter(), keep=keep)
    assert res["correct"], res["checks"]
    run = keep[0]
    got = harness.driver(run.traffic["driver"]).control(run)
    lim = harness.limits(cell)
    assert any(v > lim[k] for k, v in got.items()), (got, lim)
