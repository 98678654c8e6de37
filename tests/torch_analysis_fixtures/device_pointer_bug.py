"""Positive fixture for rule ``device-pointer``.

A kernel wrapper that hands its launch the addresses of temporaries: each
tensor below is freed as soon as its ``data_ptr()`` returns, so the
scratch buffer allocated in a later argument can take the block of the
converted starts, and the launch reads whatever the allocator wrote there.
The table's first partition and a module-level buffer are not names the
function binds either.
"""

import torch

from repro_torch.kernels import native

SCRATCH = torch.empty(0)


def rolling_sum(values, starts):
    out = torch.empty(values.shape, dtype=torch.float32, device=values.device)
    n = values.shape[0]
    err = native.library().rolling_sum_f32(
        values.contiguous().data_ptr(),
        starts.to(torch.int32).data_ptr(),
        out.data_ptr(),
        torch.empty(n, dtype=torch.float64, device=values.device).data_ptr(),
        n,
    )
    native.check(err, "rolling_sum_f32")
    return out


def lookup(tables, queries):
    return native.library().lookup(
        tables[0].data_ptr(), queries.data_ptr(), SCRATCH.data_ptr()
    )
