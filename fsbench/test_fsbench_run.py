"""Rehearsals of every cell on the CPU at a tiny size (``tiny.py``): the
result line, the JAX-free run, and ``correct`` coming out false when the
timed path is broken underneath."""

import argparse
import json
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from fsbench import faults, generate, harness, spec
from fsbench.kinds import session_prefill
from fsbench.tiny import tiny_cell

ROOT = spec.ROOT
CELLS = [w["name"] for w in spec.load()["workloads"]]
SEED = 2**31 + 11


def _line(cell, seconds=0.01):
    return harness.run_cell(cell, SEED, seconds, False, "cpu", time.perf_counter())


@pytest.mark.parametrize("name", CELLS)
def test_rehearsal_line(name):
    cell = tiny_cell(name)
    line = _line(cell)
    assert list(line) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert line["attempted"] > 0 and line["failed"] == 0
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in line["metrics"].values())
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(line["checks"]) == set(cell.limits)
    assert all(c["value"] == 0 for k, c in line["checks"].items() if k.endswith("_mismatches"))
    json.dumps(line)


def test_run_loads_no_jax_and_needs_a_card(tmp_path, capsys):
    """A whole tiny run in a fresh interpreter leaves no ``jax``, ``jaxlib``,
    ``flax`` or ``repro`` (whole top-level names) in ``sys.modules``; the
    entry point refuses without a card, and in a folder of the benchmark's
    files alone."""
    code = ("import sys, time, torch; sys.path[:0] = ['src', '.']\n"
            "torch.set_num_threads(1)\n"
            "from fsbench import harness; from fsbench.tiny import tiny_cell\n"
            f"harness.run_cell(tiny_cell({CELLS[0]!r}), 1, 0.01, False, 'cpu', time.perf_counter())\n"
            "print(harness.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
    args = ["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]
    if not torch.cuda.is_available():
        parsed = argparse.Namespace(workload=CELLS[0], seed=1, seconds=1.0, trace=0)
        assert harness.main(parsed, time.perf_counter()) != 0
        assert capsys.readouterr().out == ""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "fsbench", tmp_path / "fsbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "fsbench/run.py", *args], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


CASES = [(name, fault) for name in CELLS
         for fault in faults.BY_KIND[spec.cell(spec.load(), name).traffic["kind"]]]


@pytest.mark.parametrize("name,fault", CASES, ids=[f"{n}-{f.__name__}" for n, f in CASES])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    fault(monkeypatch.setattr)
    line = _line(tiny_cell(name))
    assert line["correct"] is False, line["checks"]


def test_latest_wins_breaks_ties_as_the_store_does():
    """Equal timestamps of one session: the first drawn wins, in the
    reference as in the program's online store."""
    from repro_torch.core.featurestore import FeatureStore

    events = {"session_id": np.array([3, 3, 5, 3, 5], np.int64),
              "ts": np.array([7, 9, 4, 9, 4], np.int64),
              "tokens": np.arange(10, dtype=np.float32).reshape(5, 2)}
    cell = tiny_cell(CELLS[0])
    job = session_prefill.SessionPrefill(cell, 1, "cpu")
    job.plane = dict(job.plane, chunk_tokens=2)
    found, vals = session_prefill.latest_by_session(events, 8)
    assert found.tolist() == [False] * 3 + [True, False, True, False, False]
    assert vals[3].tolist() == [2.0, 3.0] and vals[5].tolist() == [4.0, 5.0]
    fs = FeatureStore("ties", device="cpu", merge_engine="kernel")
    src = generate.EventSource("ev", events, "session_id")
    fs.register_source(src)
    from repro_torch.core.assets import Entity, Feature, FeatureSetSpec, MaterializationSettings
    from repro_torch.core.dsl import UDFTransform

    fs.create_feature_set(FeatureSetSpec(
        name="s", version=1, entity=Entity("session", ("session_id",)),
        features=(Feature("tok_0", "float32"), Feature("tok_1", "float32")),
        source_name="ev", transform=UDFTransform(session_prefill._identity, name="id"),
        materialization=MaterializationSettings(False, True, schedule_interval=3_600_000)))
    fs.tick(now=3_600_000)
    got, hit = fs.get_online_features("s", 1, [np.arange(8, dtype=np.int64)])
    assert np.array_equal(hit, found) and np.array_equal(got[hit], vals[found])


def test_routing_look_splits_the_deepseek_gaps():
    """The look behind the deepseek prefill cell's compared number runs on
    a tiny cell: every MoE layer recorded on both sides, the shares and
    gaps of each set of tokens read."""
    from fsbench import diag_routing

    row = diag_routing.look(tiny_cell("deepseek-v2-lite-16b.prefill-2k"), SEED, "cpu")
    assert row["moe_layers"] == 1 and row["tokens"] == 2 * 2048
    assert 0 <= row["share_served_differently_any_layer"] < 1
    assert row["tokens_alike_with_their_prefix"] > 0
    assert row["widest_gap_alike"] >= row["widest_gap_alike_with_their_prefix"] >= 0
