"""Plain PyTorch version of the point-in-time (as-of) search.

Given a feature table sorted by (entity segment, event_ts) and per-query
segment bounds [lo, hi), find for each query the greatest row index r in
[lo, hi) with table_ts[r] <= q_ts.  Returns (idx, valid): idx int32 =
lo + count - 1 (so lo - 1 where nothing qualifies), valid bool = count > 0,
where count is the number of rows of [lo, hi) at or before q_ts.

Each segment is sorted, so the count is an upper bound minus ``lo``: a
vectorised bisection over every query at once, exact on native int64 and
O(B log(max segment)) work in O(B) memory, instead of the (B, M) broadcast
the TPU oracle builds.
"""

from __future__ import annotations

import torch

__all__ = ["pit_search_ref"]


def pit_search_ref(
    table_ts: torch.Tensor,
    q_ts: torch.Tensor,
    q_lo: torch.Tensor,
    q_hi: torch.Tensor,
    probes: list | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """table_ts (M,) int64, sorted within every [lo, hi) segment; q_ts (B,)
    int64; q_lo/q_hi (B,) int32 or int64 -> (idx (B,) int32, valid (B,)
    bool), on the tensors' device.  Given a list, ``probes`` receives one
    int64 tensor per bisection step: the table rows that step reads."""
    lo0 = q_lo.to(torch.int64)
    lo, hi = lo0.clone(), q_hi.to(torch.int64)
    q = q_ts.to(torch.int64)
    m = table_ts.shape[0]
    steps = int((hi - lo).max()).bit_length() if len(lo) else 0
    for _ in range(steps):
        active = lo < hi
        mid = (lo + hi) // 2
        if probes is not None:
            probes.append(mid[active])
        at_or_before = table_ts[mid.clamp(0, max(m - 1, 0))] <= q
        lo = torch.where(active & at_or_before, mid + 1, lo)
        hi = torch.where(active & ~at_or_before, mid, hi)
    return (lo - 1).to(torch.int32), lo > lo0
