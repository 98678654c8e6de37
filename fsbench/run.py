#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 fsbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout: the port is ``src/repro_torch``, its
kernels build into ``build/kernels/`` there, and every other cache this
process writes goes to ``build/`` too.  Exits non-zero, printing no
result, without the CUDA devices the cell asks for.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _environment() -> None:
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(ROOT / "build" / sub)
    os.environ["USE_FLAX"] = "0"
    # this file's folder would shadow modules (the standard ``trace``)
    sys.path[:] = [p for p in sys.path if Path(p or ".").resolve() != ROOT / "fsbench"]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _environment()
    from fsbench import harness

    return harness.main(args, STARTED)


if __name__ == "__main__":
    sys.exit(main())
