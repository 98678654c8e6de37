"""Negative fixture for rule ``device-pointer``: the shipped wrappers.

Every address is taken of a name the function binds — a parameter, an
assignment or a loop target — behind an ``is_contiguous()`` check, so the
tensors live until the launch is queued and past it.
"""

import torch

from repro_torch.kernels import native


def rolling_sum(values, starts):
    if not (values.is_contiguous() and starts.is_contiguous()):
        raise ValueError("rolling_sum takes contiguous values and starts")
    n = values.shape[0]
    out = torch.empty(values.shape, dtype=torch.float32, device=values.device)
    scratch = torch.empty(n, dtype=torch.float64, device=values.device)
    for x in (values, starts, out):
        if x.data_ptr() % 16:
            raise ValueError("rolling_sum takes 16-byte aligned tensors")
    err = native.library().rolling_sum_f32(
        values.data_ptr(), starts.data_ptr(), out.data_ptr(), scratch.data_ptr(), n
    )
    native.check(err, "rolling_sum_f32")
    return out


def lookup(tables, queries):
    table = tables[0]
    return native.library().lookup(table.data_ptr(), queries.data_ptr())
