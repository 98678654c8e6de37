"""Plain PyTorch version of the index-free Algorithm-2 merge scan.

Table: keys (P, C) int64 (-1 empty), event_ts / creation_ts (P, C) int64,
values (P, C, D) float32.  Winners arrive routed: keys (P, Q) int64 (-2 pad,
matching nothing), event_ts (P, Q), values (P, Q, D), one creation_ts for
the batch; non-pad keys are distinct within a partition.  Every slot whose
key equals a winner's takes it iff (q_ev, creation) >lex (ev, cr).

Vectorised on native int64: each partition's winner keys are sorted once and
every slot finds its winner with ``searchsorted``, instead of the JAX
oracle's Python loop over (partition, query, slot).
"""

from __future__ import annotations

import torch

__all__ = ["match_winners", "merge_scan_ref"]


def match_winners(
    keys: torch.Tensor,
    q_keys: torch.Tensor,
    q_ev: torch.Tensor,
    sorted_q: torch.Tensor | None = None,
    order: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each slot's winner, for Q > 0: (hit (P, C) bool, where the slot's
    key is a winner's; j (P, C) int64, that winner's column in ``q_keys``;
    new_ev (P, C) int64, its event_ts), j and new_ev meaningful where hit.
    ``sorted_q``/``order`` are ``torch.sort(q_keys, dim=1)``, sorted here
    when not given."""
    if sorted_q is None:
        sorted_q, order = torch.sort(q_keys, dim=1)
    pos = torch.searchsorted(sorted_q, keys).clamp_max(q_keys.shape[1] - 1)
    j = torch.gather(order, 1, pos)
    hit = (keys >= 0) & (torch.gather(sorted_q, 1, pos) == keys)
    return hit, j, torch.gather(q_ev, 1, j)


def merge_scan_ref(
    keys: torch.Tensor,
    event_ts: torch.Tensor,
    creation_ts: torch.Tensor,
    values: torch.Tensor,
    q_keys: torch.Tensor,
    q_ev: torch.Tensor,
    q_values: torch.Tensor,
    creation: int,
    sorted_q: torch.Tensor | None = None,
    order: torch.Tensor | None = None,
) -> None:
    """Updates ``event_ts``, ``creation_ts`` and ``values`` in place."""
    if q_keys.shape[1] == 0 or keys.shape[1] == 0:
        return
    hit, j, new_ev = match_winners(keys, q_keys, q_ev, sorted_q, order)
    win = hit & (
        (new_ev > event_ts) | ((new_ev == event_ts) & (creation > creation_ts)))
    part, slot = win.nonzero(as_tuple=True)
    event_ts[part, slot] = new_ev[part, slot]
    creation_ts[part, slot] = creation
    values[part, slot] = q_values[part, j[part, slot]]
