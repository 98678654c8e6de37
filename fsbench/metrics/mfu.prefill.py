"""Model FLOPs of the window's forwards (``flops.forward_flops``: counted
from the configuration's shapes) over the window's seconds (host clock) at the
card's bf16 peak, in %."""

from fsbench import flops, peaks


def read(run):
    r = run.result
    if not r["batches"]:
        return None
    work = r["batches"] * flops.forward_flops(run.config, r["batch"], r["seq"])
    return 100.0 * work / (r["window_s"] * peaks.BF16_FLOPS)
