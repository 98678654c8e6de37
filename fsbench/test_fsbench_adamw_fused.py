"""The reader of ``adamw_fused.train``: the kernel's share of the
parameters from the program's two counters, None where either is
missing."""

import pytest

from fsbench import spec


class _Run:
    def __init__(self, counters):
        self.program = None if counters is None else {"counters": counters, "spans": {}}


@pytest.mark.parametrize("counters,want", [
    ({"adamw.fused": 3_000, "adamw.elems": 4_000}, 75.0),
    ({"adamw.fused": 0, "adamw.elems": 4_000}, 0.0),
    ({"adamw.elems": 4_000}, None),   # off the card: no kernel counted
    ({}, None),                       # a program without the counters
    (None, None),                     # no records at all
])
def test_adamw_fused_reader(counters, want):
    assert spec.metric_reader("adamw_fused.train")(_Run(counters)) == want
