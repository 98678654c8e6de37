"""The readers of the program's own spans and counters (``program.py``)
on each cell at a tiny size (``tiny.py``), its window under a CPU profiler
session: host metrics read and positive, device metrics None (no card),
MoE's fill within what the capacity allows; and None from a program that
records nothing."""

import contextlib

import pytest
import torch

from fsbench import harness, spec
from fsbench.kinds import pit_train, session_prefill
from fsbench.tiny import tiny_cell

BENCH = spec.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
SEED = 2**31 + 13
PROGRAM = {m["name"]: m for m in BENCH["per_layer"]
           if m["source"] in ("program_span", "program_counter")
           and m["name"] not in ("get_ms.prefill", "batch_ms.train")}
HOST = {"lookup_ms.prefill", "offline_read_ms.train"}
JOBS = {"session_prefill": session_prefill.SessionPrefill, "pit_train": pit_train.PitTrain}


def _window(cell, profiled: bool) -> harness.RunView:
    from repro_torch.core.monitoring import read_out

    job = JOBS[cell.traffic["kind"]](cell, SEED, "cpu")
    job.setup()
    read_out()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) if profiled else contextlib.nullcontext():
        result = job.serve(0.01)
    return harness.RunView(cell, result, job.spans, None)


@pytest.mark.parametrize("name", CELLS)
def test_readers_of_the_programs_records(name):
    cell = tiny_cell(name)
    mine = [m["name"] for m in cell.per_layer if m["name"] in PROGRAM]
    assert mine
    view = _window(cell, profiled=True)
    got = {m: spec.metric_reader(m)(view) for m in mine}
    for m, value in got.items():
        if m in HOST:
            assert value is not None and value > 0, m
        elif m == "moe_fill.prefill":
            assert 0 < value <= 100 / cell.config["capacity_factor"]
        else:
            assert value is None, m  # device seconds: no card here


def test_untraced_window_reads_nothing():
    cell = tiny_cell("deepseek-v2-lite-16b.prefill-2k")
    view = _window(cell, profiled=False)
    assert all(spec.metric_reader(m)(view) is None for m in PROGRAM)
