"""The control at a size a test run holds: the reference one precision
below the configuration's bfloat16 (float8 e4m3 products), put in the
program's place, must come out not correct by the cell's own limits and
the same verdict the result line uses, while the program's run is
correct.  One cell of each kind; on the card, at the cells' own sizes,
it is ``calibrate.py --control`` (readings and limits in PERF.md)."""

import time

import pytest

from fsbench import harness
from fsbench.tiny import tiny_cell


@pytest.mark.parametrize("name", ["phi3-medium-14b.prefill-256",
                                  "deepseek-v2-lite-16b.train-2k"])
def test_the_control_in_the_programs_place_is_not_correct(name):
    cell = tiny_cell(name)
    readings: dict = {}
    line = harness.run_cell(cell, 2**31 + 5, 0.01, False, "cpu", time.perf_counter(),
                            readings=readings, control=True)
    assert line["correct"] is True, line["checks"]
    control = harness.judge(readings["control"], cell.limits)
    assert harness.verdict(control) is False, control
