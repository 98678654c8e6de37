"""Time the port's flash backward on the card at the training shapes and at
small ragged ones.

    PYTHONPATH=src python scripts/flash_bwd_bench_torch.py [--reps 20] [--tag new]

For each shape (gemma-2b, phi3-medium-14b, zamba2-7b's shared block and
pixtral-12b as chip_smoke.py trains them: causal, bf16, S = T; and B=2
S=T=1,000 H=8 KV=2 at D 64, 128 and 256, where the host's part of a call
shows) it runs ``chip_smoke.check_flash_backward``, which checks the
gradients and the bits of two calls and times the backward (``ms``, calls
back to back between CUDA events) beside the plain version, SDPA's backward
(``library_ms``) and the bound, and adds the device ms a call of each
backward kernel and of all device work (fills included) from
``torch.profiler`` over ``--reps`` calls (``chip_profile.traced``): where
``ms`` exceeds ``device_ms`` the host holds the card back.  It prints one
JSON line a shape after ``check_flash_backward``'s own; the last line is the
card's name and power limit.

The port's modules come from the first ``src`` on PYTHONPATH (imported
before chip_smoke puts this checkout's ``src`` first), so the script times
another checkout's backward when that checkout's ``src`` comes first on
PYTHONPATH: run two versions in turns in one call on one card to compare
them.  Needs a card; exits 2 without one.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

# first, so that every module of the port comes from PYTHONPATH's checkout
from repro_torch.kernels.flash_attn import ops

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_profile as cp  # noqa: E402

# (B, S = T, H, KV, D) of each shape
SHAPES = {
    "gemma-2b": (4, 2048, 8, 1, 256),
    "phi3-medium-14b": (4, 2048, 40, 10, 128),
    "zamba2-7b": (4, 2048, 32, 32, 112),
    "pixtral-12b": (4, 3072, 32, 8, 128),
    "ragged D=64": (2, 1000, 8, 2, 64),
    "ragged D=128": (2, 1000, 8, 2, 128),
    "ragged D=256": (2, 1000, 8, 2, 256),
}
KEYS = ("shape", "route", "B", "S", "H", "KV", "D", "max_abs_err", "ms", "plain_ms",
        "bound_ms", "bound_by", "library_ms")


def bench(name: str, reps: int) -> dict:
    b, s, h, kv, d = SHAPES[name]
    row = cp.cs.check_flash_backward(b, s, h, kv, d, np.random.default_rng(0), name, reps=reps)
    rng = np.random.default_rng(1)
    up = lambda shape: torch.from_numpy(  # noqa: E731
        rng.standard_normal(shape, np.float32)).to("cuda", torch.bfloat16)
    q, k, v, do = up((b, s, h, d)), up((b, s, kv, d)), up((b, s, kv, d)), up((b, s, h, d))
    _, lse = ops._forward(q, k, v, True, True)

    def calls():
        for _ in range(reps):
            ops._backward(q, k, v, lse, do, True)

    calls()  # warm-up
    _, dev_ops = cp.traced(calls, torch.device("cuda"))
    return {**{key: row[key] for key in KEYS},
            "kernels_ms": {key: ms / reps for key, ms in cp.flash_bwd_kernels(dev_ops).items()},
            "device_ms": sum(v["device_ms"] for v in dev_ops.values()) / reps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--tag", default="", help="a label printed in every row")
    ap.add_argument("--shapes", nargs="*", default=list(SHAPES), choices=list(SHAPES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("flash_bwd_bench_torch: no CUDA device visible", file=sys.stderr)
        return 2
    for name in args.shapes:
        print(json.dumps({"tag": args.tag, **bench(name, args.reps)}), flush=True)
        torch.cuda.empty_cache()
    print(cp.cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
