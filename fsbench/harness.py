"""One run of one cell: the cell's files by name (``spec.py``), the module
its traffic's ``kind`` names (``kinds/``), then the result line.

With ``--trace 0`` the line carries the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics (each read by ``metrics/<name>.py``
from the run's spans, counters and device trace; a reader that finds
nothing returns None and the metric is left out) and the breakdown.  Both
check what the timed path produced against the cell's limits
(``limits/<cell>.json``) and print each number beside its limit, last on
standard error and under ``checks``, last in the line.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from fsbench import spec

__all__ = ["FORBIDDEN", "judge", "main", "run_cell", "verdict"]

#: top-level module names that must not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class RunView:
    """What a per-layer reader reads: the cell, the window's counters,
    the host spans and the device trace (None without ``--trace 1``)."""

    def __init__(self, cell, result: dict, spans: dict, trace) -> None:
        self.cell, self.config, self.traffic = cell, cell.config, cell.traffic
        self.result, self.spans, self.trace = result, spans, trace


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def judge(checks: dict, limits: dict) -> dict:
    """Each number the cell's limits file names, beside its limit (None
    where the run did not read it: not correct)."""
    return {k: {"value": checks.get(k), "limit": lim} for k, lim in limits.items()}


def verdict(judged: dict) -> bool:
    """``correct``: every number read and within its limit."""
    return all(c["value"] is not None and c["value"] <= c["limit"] for c in judged.values())


def run_cell(cell, seed: int, seconds: float, traced: bool, device, started: float,
             stages: dict | None = None, readings: dict | None = None,
             control: bool = False) -> dict:
    """The result line of one run.  ``stages`` gets the seconds of its
    parts, ``readings`` every number the checks read (``program``) and,
    with ``control``, those of the control in the program's place
    (``control``), which the benchmark's own runs never compute."""
    out = spec.kind(cell.traffic).run(cell, seed, seconds, traced, device, control)
    if stages is not None:
        stages.update(out["stages"], window_s=out["result"]["window_s"])
    if readings is not None:
        readings.update(program=out["checks"], control=out["control_checks"])
    res = out["result"]
    checks = judge(out["checks"], cell.limits)
    line = {"correct": verdict(checks), "attempted": res["attempted"], "failed": 0}
    if traced:
        view = RunView(cell, res, out["spans"], out["trace"])
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(view)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(res, setup_s=out["setup_done"] - started)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    line["metrics"] = metrics
    dev = torch.device(device)
    line["device"] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "count": cell.chips, "memory_peak_bytes": out["memory_peak"]}
    if traced:
        tr = out["trace"]
        line["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        line["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    line["checks"] = checks
    return line


def _power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def main(args, started: float) -> int:
    bench = spec.load()
    cell = spec.cell(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"fsbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    stages: dict = {}
    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", started, stages)
    found = forbidden_modules()
    if found:
        print(f"fsbench: the run loaded {', '.join(found)}; no result", file=sys.stderr)
        return 3
    line["device"]["power"] = _power_limit()
    print("fsbench: stages " + json.dumps({k: round(v, 3) for k, v in stages.items()}),
          file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
