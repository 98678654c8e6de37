"""The flash forward kernels' least time at each call's shape
(``flops.flash_fwd_bound_s``) over their device time in the trace, in %."""

from fsbench import flops


def read(run):
    if run.trace is None:
        return None
    times = [dur for name, _, dur in run.trace.kernels if "flash_fwd" in name]
    if not times:
        return None
    r = run.result
    bound = flops.flash_fwd_bound_s(run.config, r["batch"], r["seq"])
    return 100.0 * len(times) * bound / sum(times)
