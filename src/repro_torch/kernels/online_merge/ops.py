"""The resident Algorithm-2 merge of the online store's kernel engine.

  * ``merge_at_slots`` — the store's sorted key index has already resolved
    each winner record to its (partition, slot), so the compare-and-update
    is an O(batch) gather / compare / scatter, in place on the resident
    tensors (``index_put_``): nothing table-sized crosses host<->device.  The
    latest-wins decision itself runs on the table's device against device
    truth, so the device tensors are a self-contained Algorithm-2 state
    machine.
  * ``gather_slot_ts`` — the read half of the protocol: (event_ts,
    creation_ts) at resolved coords, so the host merge plan computes exact
    tallies against device truth without pulling whole tables back.

The JAX package computes both in XLA, not Pallas; they stay plain PyTorch.
"""

from __future__ import annotations

import torch

__all__ = ["gather_slot_ts", "merge_at_slots"]


def merge_at_slots(
    keys: torch.Tensor,
    event_ts: torch.Tensor,
    creation_ts: torch.Tensor,
    values: torch.Tensor,
    part: torch.Tensor,
    slot: torch.Tensor,
    q_keys: torch.Tensor,
    is_new: torch.Tensor,
    q_event_ts: torch.Tensor,
    creation: torch.Tensor,
    q_values: torch.Tensor,
) -> None:
    """In-place compare-and-update at index-resolved slots.

    Table tensors: ``keys``/``event_ts``/``creation_ts`` (P, C) int64,
    ``values`` (P, C, D) f32.  Batch (G,): ``part``/``slot`` target coords,
    ``q_keys`` the keys to stamp where ``is_new`` (fresh inserts, possibly
    into recycled slots), ``q_event_ts`` the winners' event_ts, ``creation``
    a (1,) int64 tensor holding the batch's shared creation_ts, ``q_values``
    (G, D).  Coords must be distinct and in bounds (the merge plan gives one
    winner per id, the index one slot per id).

    Algorithm 2, online branch, per coord: a new slot always takes the
    record; a live slot takes it iff (ev, cr) >lex (old_ev, old_cr)."""
    idx = (part.long(), slot.long())
    old_ev = event_ts[idx]
    old_cr = creation_ts[idx]
    cr = creation.expand_as(old_cr)
    win = is_new | (q_event_ts > old_ev) | ((q_event_ts == old_ev) & (cr > old_cr))
    keys.index_put_(idx, torch.where(is_new, q_keys, keys[idx]))
    event_ts.index_put_(idx, torch.where(win, q_event_ts, old_ev))
    creation_ts.index_put_(idx, torch.where(win, cr, old_cr))
    values.index_put_(idx, torch.where(win[:, None], q_values, values[idx]))


def gather_slot_ts(
    event_ts: torch.Tensor,
    creation_ts: torch.Tensor,
    part: torch.Tensor,
    slot: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(part, slot) (G,) -> (event_ts, creation_ts) (G,) int64 at those
    coords — the O(batch) read that lets the host merge plan see device
    truth without syncing whole tables."""
    idx = (part.long(), slot.long())
    return event_ts[idx], creation_ts[idx]
