"""Plain PyTorch versions of the rolling-window aggregations.

``out[i] = agg(values[starts[i] : i+1])`` — the window is a contiguous row
span ending at row ``i`` (rows are sorted by (entity, timestamp) upstream; the
DSL computes ``starts`` so windows never cross entity boundaries).
"""

from __future__ import annotations

import torch

__all__ = ["rolling_minmax", "rolling_sum_ref"]


def rolling_sum_ref(values: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """Prefix difference in float64, one rounding to float32: values (N, F)
    float32, starts (N,) int -> (N, F) float32.  The float64 prefix keeps
    the cancellation error far below float32 resolution at any span."""
    v = values.to(torch.float64)
    prefix = torch.zeros((v.shape[0] + 1, v.shape[1]), dtype=torch.float64,
                         device=v.device)
    torch.cumsum(v, dim=0, out=prefix[1:])
    return (prefix[1:] - prefix[starts.long()]).to(torch.float32)


def rolling_minmax(values: torch.Tensor, starts: torch.Tensor,
                   agg: str) -> torch.Tensor:
    """Windowed min or max through a sparse table: level k holds the
    min/max of each run of 2**k rows, and a window of span s is covered by
    two overlapping runs of 2**floor(log2 s) rows.  min/max round nothing,
    so this equals a masked reduction over the window exactly, in
    O(N·F·log(max span)) work instead of O(N²·F)."""
    if agg not in ("min", "max"):
        raise ValueError(f"rolling_minmax takes 'min' or 'max', got {agg!r}")
    op = torch.minimum if agg == "min" else torch.maximum
    v = values.to(torch.float32)
    n = v.shape[0]
    if n == 0:
        return v.clone()
    starts = starts.to(device=v.device, dtype=torch.int64)
    rows = torch.arange(n, device=v.device)
    spans = rows + 1 - starts
    level = torch.zeros(n, dtype=torch.int64, device=v.device)
    while bool((spans >= (2 << level)).any()):
        level += (spans >= (2 << level)).to(torch.int64)
    levels = [v]
    for k in range(1, int(level.max()) + 1):
        prev, half = levels[-1], 1 << (k - 1)
        nxt = prev.clone()
        nxt[: n - half] = op(prev[: n - half], prev[half:])
        levels.append(nxt)
    table = torch.stack(levels)  # (L, N, F)
    right = rows + 1 - (1 << level)
    return op(table[level, starts], table[level, right])
