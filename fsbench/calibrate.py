#!/usr/bin/env python3
"""Readings that a cell's limits are set from, in one process: each seed
is a run of the cell (``harness.run_cell``) with a short window at the
cell's own load (``SECONDS``), on the card; on ``--control`` seeds the control (the
reference one precision below the configuration's) is also put in the
program's place and judged by the same limits.  Not run by the
benchmark's own runs.

    python3 fsbench/calibrate.py --workload <cell> --seeds 1 2 3 --control 1 2 3

Prints one JSON line a seed: ``correct`` and every number the checks
read, and on control seeds ``control_correct`` and the control's numbers;
with ``--out`` it also appends them to that file.
"""

import argparse
import json
import sys
import time

import run as entry

#: each run's window: long enough to finish a batch or step of the cell's
#: own load; the sample compared is a run's
SECONDS = 3.0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", type=int, nargs="*", default=[])
    ap.add_argument("--fault", default="", help="a fault of faults.py planted under the timed path")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    entry._environment()
    from fsbench import faults, harness, spec

    cell = spec.cell(spec.load(), args.workload)
    if args.fault:
        faults.BY_NAME[args.fault](setattr)
    for seed in args.seeds:
        t0 = time.perf_counter()
        readings: dict = {}
        line = harness.run_cell(cell, seed, SECONDS, False, "cuda", t0,
                                readings=readings, control=seed in args.control)
        row = {"workload": args.workload, "seed": seed, "fault": args.fault,
               "correct": line["correct"], **readings["program"]}
        if readings["control"] is not None:
            row["control_correct"] = harness.verdict(harness.judge(readings["control"],
                                                                   cell.limits))
            row.update(("control_" + k, v) for k, v in readings["control"].items())
        row["seconds"] = time.perf_counter() - t0
        print(json.dumps(row), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
