"""Model FLOPs of the window's training steps (``flops.train_flops``:
three forwards' worth, counted from the configuration's shapes) over the
window's seconds (host clock) at the card's bf16 peak, in %."""

from fsbench import flops, peaks


def read(run):
    r = run.result
    if not r["steps"]:
        return None
    work = r["steps"] * flops.train_flops(run.config, r["batch"], r["seq"])
    return 100.0 * work / (r["window_s"] * peaks.BF16_FLOPS)
