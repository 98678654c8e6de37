"""Vectorized Algorithm-2 merge engine (paper §4.5) — shared batch reduction.

Both stores' write paths funnel a materialization frame through the same
pre-reduction: group the batch by entity id (stable, preserving arrival
order within each id), find each id's latest-wins winner, and derive the
EXACT per-row insert/override/no-op decisions the sequential Algorithm-2
loop would have made — without running it row by row.

The decision rule being vectorized (online branch, one batch shares a single
``creation_ts``):

  * first row of an id absent from the store          -> insert
  * row whose event_ts exceeds the running maximum
    (store record, then every earlier batch row)      -> override
  * row tying the STORE record's event_ts before any
    batch row improved it, with newer creation_ts     -> override (tie rule)
  * everything else                                   -> no-op

``segmented_exclusive_prefix_max`` provides the running maximum per id via a
log-step Hillis–Steele scan, so a B-row batch reduces in O(B log B) numpy ops
regardless of duplicate structure.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Optional

import numpy as np

__all__ = [
    "INT64_MIN",
    "OnlineBatchPlan",
    "argsort_ids",
    "merge_sorted",
    "plan_online_batch",
    "segmented_exclusive_prefix_max",
]


def argsort_ids(a: np.ndarray) -> np.ndarray:
    """Stable ascending argsort for NON-NEGATIVE int64 keys via 4-pass
    16-bit radix.

    numpy's ``kind="stable"`` falls back to comparison mergesort for 64-bit
    ints (radix only kicks in at <=16 bits), costing ~16ms per 100k keys;
    ``np.lexsort`` over the four little-endian uint16 digit planes runs a
    stable radix pass per plane (~4x faster) and yields the same order
    because every key is non-negative (entity keys are sign-bit-cleared by
    the codec, full-key hashes by ``encode_full_keys``).
    """
    if len(a) < 2048 or sys.byteorder != "little":
        return np.argsort(a, kind="stable")  # radix setup doesn't pay / BE
    digits = np.ascontiguousarray(a).view(np.uint16).reshape(-1, 4)
    # little-endian: plane 0 least significant; lexsort's LAST key is primary
    return np.lexsort((digits[:, 0], digits[:, 1], digits[:, 2], digits[:, 3]))

INT64_MIN = np.int64(np.iinfo(np.int64).min)


def segmented_exclusive_prefix_max(
    seg_ids: np.ndarray, values: np.ndarray
) -> np.ndarray:
    """Running max of every PRIOR element within each segment.

    ``seg_ids`` must be non-decreasing (rows grouped by segment); the first
    row of each segment gets ``INT64_MIN``.  Hillis–Steele doubling: each
    step is a full-width vector max, so the scan is O(n log n) element ops
    with no Python-level per-row work.
    """
    n = len(values)
    out = np.empty(n, np.int64)
    if n == 0:
        return out
    out[0] = INT64_MIN
    out[1:] = values[:-1]
    seg_first = np.empty(n, bool)
    seg_first[0] = True
    seg_first[1:] = seg_ids[1:] != seg_ids[:-1]
    out[seg_first] = INT64_MIN
    # the scan saturates once the doubling shift covers the LONGEST segment,
    # which for merge batches (few duplicates per id) is typically 2-4 rows —
    # so this usually runs 1-2 passes, not log2(n)
    starts = np.flatnonzero(seg_first)
    max_run = int(np.diff(np.append(starts, n)).max())
    shift = 1
    while shift < max_run:
        same = seg_ids[shift:] == seg_ids[:-shift]
        out[shift:] = np.where(same, np.maximum(out[shift:], out[:-shift]), out[shift:])
        shift *= 2
    return out


def merge_sorted(
    a_list: list[np.ndarray],
    b_list: list[np.ndarray],
    pos: Optional[np.ndarray] = None,
) -> list[np.ndarray]:
    """Merge sorted-key parallel arrays ``b_list`` into ``a_list``.

    ``a_list[0]``/``b_list[0]`` are the sorted keys; trailing arrays are
    payloads permuted identically.  ``pos`` (``searchsorted(a0, b0)``) can be
    passed in when the caller already computed it for a membership probe —
    the merge is then three vectorized scatters, an order of magnitude
    cheaper than per-array ``np.insert``.
    """
    a0, b0 = a_list[0], b_list[0]
    if pos is None:
        pos = np.searchsorted(a0, b0)
    k, m = len(a0), len(b0)
    new_at = pos + np.arange(m)
    old_at = np.ones(k + m, bool)
    old_at[new_at] = False
    out = []
    for a, b in zip(a_list, b_list):
        merged = np.empty(k + m, a.dtype)
        merged[new_at] = b
        merged[old_at] = a
        out.append(merged)
    return out


@dataclasses.dataclass
class OnlineBatchPlan:
    """Per-unique-id reduction of one merge batch + exact Algorithm-2 tallies.

    Arrays are aligned on the batch's unique ids in ascending id order
    (``uids``); ``winner_row`` indexes back into the ORIGINAL frame.
    """

    uids: np.ndarray  # (G,) int64, ascending
    winner_row: np.ndarray  # (G,) int64 — original row of the winning record
    winner_ev: np.ndarray  # (G,) int64 — the id's max event_ts in the batch
    first_row: np.ndarray  # (G,) int64 — original row of first occurrence
    # beat is the write mask: True exactly where the store state changes
    # (fresh inserts and winners beating the stored record).  The per-batch
    # stats a merge returns (tallies + touched-slot coords) are this plan
    # masked down — nothing is re-derived from store state after the apply,
    # which is what lets the device-resident engine skip pulling planes back.
    beat: np.ndarray  # (G,) bool — store record must be (re)written
    is_new: np.ndarray  # (G,) bool — id absent from the store
    inserts: int
    overrides: int
    noops: int


def plan_online_batch(
    ids: np.ndarray,
    event_ts: np.ndarray,
    creation_ts: int,
    resolve: Callable[[np.ndarray], tuple[np.ndarray, np.ndarray, np.ndarray]],
) -> OnlineBatchPlan:
    """Reduce a batch to per-id winners + exact sequential-loop counters.

    ``resolve(uids)`` returns ``(old_ev, old_cr, found)`` — the store's
    current record per unique id (ascending id order); ``old_ev``/``old_cr``
    entries where ``found`` is False are ignored.  Taking a callback keeps
    the batch's single stable id-sort HERE (the store would otherwise pay a
    second full sort for ``np.unique``).
    """
    n = len(ids)
    if n == 0:
        empty = np.empty(0, np.int64)
        return OnlineBatchPlan(
            uids=empty, winner_row=empty, winner_ev=empty, first_row=empty,
            beat=np.empty(0, bool), is_new=np.empty(0, bool),
            inserts=0, overrides=0, noops=0,
        )
    order = argsort_ids(ids)  # groups ids, keeps arrival order (stable)
    sid = ids[order]
    sev = event_ts[order].astype(np.int64)

    seg_first = np.empty(n, bool)
    seg_first[0] = True
    seg_first[1:] = sid[1:] != sid[:-1]
    # int32 segment labels: halves the scan's compare traffic vs int64
    seg_idx = np.cumsum(seg_first, dtype=np.int32) - 1
    starts = np.flatnonzero(seg_first)

    uids = sid[starts]
    old_ev, old_cr, found = resolve(uids)
    gmax = np.maximum.reduceat(sev, starts)
    # winner = FIRST batch row reaching the group max (later ties are no-ops)
    cand = np.where(sev == gmax[seg_idx], np.arange(n), n)
    winner_row = order[np.minimum.reduceat(cand, starts)]
    first_row = order[starts]

    pm = segmented_exclusive_prefix_max(seg_idx, sev)
    found_r = found[seg_idx]
    old_ev_r = np.where(found_r, old_ev[seg_idx], INT64_MIN)
    old_cr_r = np.where(found_r, old_cr[seg_idx], INT64_MIN)

    insert_r = seg_first & ~found_r
    # override: beats the running max (store record folded in), or the
    # one-shot creation-ts tie against the untouched store record
    ev_gt = sev > np.maximum(pm, old_ev_r)
    tie = found_r & (sev == old_ev_r) & (pm < old_ev_r) & (creation_ts > old_cr_r)
    override_r = (ev_gt | tie) & ~insert_r

    beat = np.where(
        found,
        (gmax > old_ev) | ((gmax == old_ev) & (creation_ts > old_cr)),
        True,
    )
    n_ins = int(insert_r.sum())
    n_ovr = int(override_r.sum())
    return OnlineBatchPlan(
        uids=uids,
        winner_row=winner_row,
        winner_ev=gmax,
        first_row=first_row,
        beat=beat,
        is_new=~found,
        inserts=n_ins,
        overrides=n_ovr,
        noops=n - n_ins - n_ovr,
    )
