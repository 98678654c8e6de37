"""The online store's Algorithm-2 merge: the resident form and the scan.

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
  * ``merge`` / ``route_and_merge`` — the index-free variant: a batch of
    per-id winners routed to hash partitions, matched against every slot by
    key with no host-side slot index.  ``merge`` is the kernel wrapper (a
    CUDA tensor launches ``csrc/merge_scan.cu``, a CPU tensor runs the plain
    version in ``ref.py``); ``route_and_merge`` is its numpy-in / numpy-out
    form with value semantics.

The JAX package computes the first two in XLA, not Pallas; they stay plain
PyTorch.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import native
from repro_torch.kernels.online_lookup.ops import pow2_bucket, route_flat
from repro_torch.kernels.online_merge.ref import merge_scan_ref

__all__ = [
    "counter",
    "gather_slot_ts",
    "merge",
    "merge_at_slots",
    "route_and_merge",
    "route_winners",
]

PAD = -2  # routed pad key: matches neither a live key (>= 0) nor an empty slot (-1)

counter = native.LaunchCounter("merge_scan")


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


def _check_merge_args(keys, event_ts, creation_ts, values, q_keys, q_ev, q_values) -> None:
    for name, t in (("keys", keys), ("event_ts", event_ts), ("creation_ts", creation_ts),
                    ("q_keys", q_keys), ("q_ev", q_ev)):
        if t.dtype != torch.int64:
            raise TypeError(f"merge takes int64 {name}, got {t.dtype}")
    if values.dtype != torch.float32 or q_values.dtype != torch.float32:
        raise TypeError(f"merge takes float32 values, got {values.dtype}, {q_values.dtype}")
    if keys.dim() != 2 or q_keys.dim() != 2 or values.dim() != 3:
        raise ValueError("merge takes keys (P, C), values (P, C, D) and q_keys (P, Q)")
    p, c = keys.shape
    q, d = q_keys.shape[1], values.shape[2]
    expect = {
        "event_ts": (event_ts, (p, c)), "creation_ts": (creation_ts, (p, c)),
        "values": (values, (p, c, d)), "q_keys": (q_keys, (p, q)),
        "q_ev": (q_ev, (p, q)), "q_values": (q_values, (p, q, d)),
    }
    for name, (t, shape) in expect.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    tensors = (keys, event_ts, creation_ts, values, q_keys, q_ev, q_values)
    if len({t.device for t in tensors}) != 1:
        raise ValueError("merge takes tensors on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("merge takes contiguous tensors")
    if p > 65535 or max(c, q, d) >= 2**31:
        raise ValueError("merge takes at most 65,535 partitions and int32-sized C, Q, D")


def _check_winner_keys(q_keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Sort each partition's winner keys; raise unless every key is a pad
    or live (>= 0) and the live ones are distinct.  Returns (sorted, order)."""
    sorted_q, order = torch.sort(q_keys, dim=1)
    bad_key, dup = torch.stack([
        ((q_keys < 0) & (q_keys != PAD)).any(),
        ((sorted_q[:, 1:] == sorted_q[:, :-1]) & (sorted_q[:, 1:] >= 0)).any(),
    ]).tolist()
    if bad_key:
        raise ValueError(f"winner keys must be live (>= 0) or the pad {PAD}")
    if dup:
        raise ValueError("winner keys must be distinct within a partition")
    return sorted_q, order


def merge(
    keys: torch.Tensor,
    event_ts: torch.Tensor,
    creation_ts: torch.Tensor,
    values: torch.Tensor,
    q_keys: torch.Tensor,
    q_ev: torch.Tensor,
    q_values: torch.Tensor,
    batch_creation_ts: int,
) -> None:
    """Pre-routed index-free merge, IN PLACE on ``event_ts``,
    ``creation_ts`` and ``values``.

    Table: ``keys`` (P, C) int64 (-1 empty), ``event_ts``/``creation_ts``
    (P, C) int64, ``values`` (P, C, D) float32.  Winners: ``q_keys`` (P, Q)
    int64, each live key at most once per partition, ``PAD`` (-2) elsewhere;
    ``q_ev`` (P, Q) int64, ``q_values`` (P, Q, D) float32; one
    ``batch_creation_ts`` for the batch.  Every slot whose key equals a
    winner's takes (q_ev, batch_creation_ts, values) iff that pair is
    lexicographically greater than the slot's (event_ts, creation_ts).
    Callers routing fresh inserts this way stamp their slots with INT64_MIN
    timestamps first, so any real record wins them.  Runs where the tensors
    lie: CUDA launches the kernel, CPU runs the plain version."""
    _check_merge_args(keys, event_ts, creation_ts, values, q_keys, q_ev, q_values)
    if keys.device.type == "cpu":
        sorted_q, order = _check_winner_keys(q_keys)
        merge_scan_ref(keys, event_ts, creation_ts, values, q_keys, q_ev, q_values,
                       int(batch_creation_ts), sorted_q, order)
        return
    if keys.device.type != "cuda":
        raise ValueError(f"merge runs on cuda or cpu, not {keys.device}")
    with torch.cuda.device(keys.device):
        sorted_q, order = _check_winner_keys(q_keys)
        _launch(keys, event_ts, creation_ts, values, sorted_q, order, q_ev, q_values,
                int(batch_creation_ts))


def _launch(keys, event_ts, creation_ts, values, sorted_q, order, q_ev, q_values,
            creation: int) -> None:
    """Launch the kernel on checked CUDA tensors, with each partition's
    winner keys sorted (``sorted_q``, and ``order`` their columns in
    ``q_keys``), on the current stream, and count the launch.  An empty
    table or batch launches nothing and counts nothing."""
    p, c = keys.shape
    q, d = sorted_q.shape[1], values.shape[2]
    if p * c * q == 0:
        return
    err = native.library().merge_scan_i64(
        keys.data_ptr(), event_ts.data_ptr(), creation_ts.data_ptr(), values.data_ptr(),
        sorted_q.data_ptr(), order.data_ptr(), q_ev.data_ptr(), q_values.data_ptr(),
        creation, p, c, q, d, torch.cuda.current_stream().cuda_stream,
    )
    native.check(err, "merge_scan_i64")
    counter.add()


def route_winners(
    num_partitions: int, ids: np.ndarray, ev: np.ndarray, vals: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flat per-id winners -> the routed (q_keys, q_ev, q_values) ``merge``
    takes, each partition's row padded to a power of two (``pow2_bucket``)
    with ``PAD`` keys and zero payloads."""
    q_ids, _, _, q_ev, q_vals = route_flat(
        num_partitions, np.asarray(ids, np.int64), np.asarray(ev, np.int64),
        np.asarray(vals, np.float32),
    )
    extra = pow2_bucket(q_ids.shape[1]) - q_ids.shape[1]
    if extra:
        q_ids = np.pad(q_ids, ((0, 0), (0, extra)), constant_values=PAD)
        q_ev = np.pad(q_ev, ((0, 0), (0, extra)))
        q_vals = np.pad(q_vals, ((0, 0), (0, extra), (0, 0)))
    return q_ids, q_ev, q_vals


def route_and_merge(
    keys: np.ndarray,
    event_ts: np.ndarray,
    creation_ts: np.ndarray,
    values: np.ndarray,
    ids: np.ndarray,
    ev: np.ndarray,
    vals: np.ndarray,
    batch_creation_ts: int,
    *,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Flat merge path: winner records ids (B,) int64 (UNIQUE), ev (B,)
    int64, vals (B, D) f32 against a table of int64 keys (P, C), int64
    event_ts/creation_ts and f32 values (P, C, D), merged on ``device``.

    Returns new host-side (event_ts, creation_ts, values); the inputs are
    left untouched."""
    ids = np.asarray(ids, np.int64)
    if len(ids) == 0:
        return event_ts.copy(), creation_ts.copy(), values.copy()
    dev = resolve_device(device)
    up = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev, copy=True)
    q_ids, q_ev, q_vals = route_winners(keys.shape[0], ids, ev, vals)
    t_ev, t_cr = up(event_ts, np.int64), up(creation_ts, np.int64)
    t_vals = up(values, np.float32)
    merge(up(keys, np.int64), t_ev, t_cr, t_vals, up(q_ids, np.int64), up(q_ev, np.int64),
          up(q_vals, np.float32), batch_creation_ts)
    return t_ev.cpu().numpy(), t_cr.cpu().numpy(), t_vals.cpu().numpy()
