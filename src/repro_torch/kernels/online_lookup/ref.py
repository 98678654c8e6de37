"""Plain PyTorch version of the partitioned online-store lookup.

Table layout: int64 keys (P, C), P hash partitions of C slots, -1 in an empty
slot.  Queries arrive routed to their partition: (P, Q) int64, -2 for a pad.
Result: (P, Q) int32, the largest slot whose key equals the query, or -1.

Each partition's keys are stable-sorted once and every query is placed with
``searchsorted``: exact, the max slot among equal keys (a stable sort keeps
equal keys in slot order, so the rightmost is the largest slot), and O(P*C)
memory instead of the (P, Q, C) broadcast the TPU oracle builds.
"""

from __future__ import annotations

import torch

__all__ = ["lookup_ref"]


def lookup_ref(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    p, c = keys.shape
    q = queries.shape[1]
    if c == 0:
        return torch.full((p, q), -1, dtype=torch.int32, device=keys.device)
    sorted_keys, order = torch.sort(keys, dim=1, stable=True)
    pos = torch.searchsorted(sorted_keys, queries, right=True) - 1
    safe = pos.clamp_min(0)
    hit = (pos >= 0) & (torch.gather(sorted_keys, 1, safe) == queries)
    slot = torch.gather(order, 1, safe)
    return torch.where(hit, slot, torch.full_like(slot, -1)).to(torch.int32)
