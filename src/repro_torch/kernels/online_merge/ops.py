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

The winner keys are data, so on the card they are checked by the kernel,
not by a synchronizing reduction here: a batch with a key that is neither
live nor ``PAD``, or with a live key twice in one partition, changes no slot
and sets its device's word in ``errors``.  The reliable read is after a
synchronization: ``route_and_merge`` after its download, ``check_error`` for
a direct caller after ``torch.cuda.synchronize()``.  The next launch on the
device reads the word too, as a best-effort net whose timing is not fixed
(``native.ErrorWord``).  The CPU path checks eagerly and reads no word.

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
    "check_error",
    "counter",
    "errors",
    "gather_slot_ts",
    "merge",
    "merge_at_slots",
    "route_and_merge",
    "route_winners",
]

PAD = -2  # routed pad key: matches neither a live key (>= 0) nor an empty slot (-1)
BAD_KEY_MESSAGE = f"winner keys must be live (>= 0) or the pad {PAD}"
DUPLICATE_MESSAGE = "winner keys must be distinct within a partition"
# a partition's hash of winner keys is used in shared memory up to this size
# (kMaxSharedHash in csrc/merge_scan.cu), and in the scratch past it
HASH_SHARED_BYTES = 96 * 1024
HASH_ENTRY_BYTES = 12  # an int64 key and an int32 owner

counter = native.LaunchCounter("merge_scan")
# bit 0: a bad winner key, bit 1: a duplicate, as the kernel reports them
errors = native.ErrorWord(BAD_KEY_MESSAGE, DUPLICATE_MESSAGE)


def check_error(device: torch.device | str | None = None) -> None:
    """Raise ``ValueError`` if a merge on ``device`` (on any device where
    None) since the last check was refused for its winner keys, and clear
    the report.  Reliable after a synchronization of the device: it sees the
    launches that finished before it."""
    errors.raise_if_set(device)


def hash_entries(q: int) -> int:
    """Entries of one partition's hash of q winner keys: a power of two of
    at least 2q (at most half full), and at least 4."""
    return pow2_bucket(2 * q, floor=4)


def hash_in_shared(q: int) -> bool:
    """Whether the kernel keeps the hash of q winner keys in shared memory."""
    return HASH_ENTRY_BYTES * hash_entries(q) <= HASH_SHARED_BYTES


def filter_size(q: int) -> int:
    """Bits of the filter in front of the hash of q winner keys: a power of
    two of at least 64q, between 2**10 and 2**20."""
    return min(pow2_bucket(64 * q, floor=1 << 10), 1 << 20)


def scratch_len(p: int, q: int) -> int:
    """int64 words of the kernel's scratch for P partitions of Q winners:
    the verdict word (padded to 16 bytes), and every partition's hash and
    filter, which the check kernel builds and the update kernel reads."""
    return 2 + p * (HASH_ENTRY_BYTES * hash_entries(q) + filter_size(q) // 8) // 8


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


def _check_merge_args(keys, event_ts, creation_ts, values, q_keys, q_ev,
                      q_values) -> None:
    for name, t in (("keys", keys), ("event_ts", event_ts),
                    ("creation_ts", creation_ts), ("q_keys", q_keys), ("q_ev", q_ev)):
        if t.dtype != torch.int64:
            raise TypeError(f"merge takes int64 {name}, got {t.dtype}")
    if values.dtype != torch.float32 or q_values.dtype != torch.float32:
        raise TypeError(
            f"merge takes float32 values, got {values.dtype}, {q_values.dtype}")
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
    if max(p, c, q, d) >= 2**31:
        raise ValueError("merge takes int32-sized P, C, Q and D")


def _check_winner_keys(q_keys: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The CPU path's eager check: sort each partition's winner keys; raise
    unless every key is a pad or live (>= 0) and the live ones are distinct.
    Returns (sorted, order)."""
    sorted_q, order = torch.sort(q_keys, dim=1)
    if bool(((q_keys < 0) & (q_keys != PAD)).any()):
        raise ValueError(BAD_KEY_MESSAGE)
    if bool(((sorted_q[:, 1:] == sorted_q[:, :-1]) & (sorted_q[:, 1:] >= 0)).any()):
        raise ValueError(DUPLICATE_MESSAGE)
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
    lie: CUDA launches the kernel, CPU runs the plain version.  Bad winner
    keys raise ``ValueError`` here on the CPU; on the card the batch changes
    nothing and raises at a later read of ``errors`` (see the module's
    docstring).  An empty table or batch checks nothing on the card."""
    _check_merge_args(keys, event_ts, creation_ts, values, q_keys, q_ev, q_values)
    if keys.device.type == "cpu":
        sorted_q, order = _check_winner_keys(q_keys)
        merge_scan_ref(keys, event_ts, creation_ts, values, q_keys, q_ev, q_values,
                       int(batch_creation_ts), sorted_q, order)
        return
    if keys.device.type != "cuda":
        raise ValueError(f"merge runs on cuda or cpu, not {keys.device}")
    p, q = q_keys.shape
    with torch.cuda.device(keys.device):
        scratch = torch.empty(scratch_len(p, q), dtype=torch.int64, device=keys.device)
        _launch(keys, event_ts, creation_ts, values, q_keys, q_ev, q_values, scratch,
                int(batch_creation_ts))


def _launch(keys, event_ts, creation_ts, values, q_keys, q_ev, q_values, scratch,
            creation: int) -> None:
    """Launch the kernel on checked CUDA tensors, with ``scratch``
    (``scratch_len`` int64 words), on the current stream, and count the
    launch; first raise an unread report of the device.  An empty table or
    batch launches nothing and counts nothing."""
    p, c = keys.shape
    q, d = q_keys.shape[1], values.shape[2]
    if p * c * q == 0:
        return
    errors.raise_if_set(keys.device)
    err = native.library().merge_scan_i64(
        keys.data_ptr(), event_ts.data_ptr(), creation_ts.data_ptr(), values.data_ptr(),
        q_keys.data_ptr(), q_ev.data_ptr(), q_values.data_ptr(), scratch.data_ptr(),
        scratch.numel(), errors.ptr(keys.device), creation, p, c, q, d,
        torch.cuda.current_stream().cuda_stream,
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
    left untouched.  Bad winner ids raise ``ValueError`` (on the card after
    the download, from ``errors``)."""
    ids = np.asarray(ids, np.int64)
    if len(ids) == 0:
        return event_ts.copy(), creation_ts.copy(), values.copy()
    dev = resolve_device(device)
    up = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev, copy=True)
    q_ids, q_ev, q_vals = route_winners(keys.shape[0], ids, ev, vals)
    t_ev, t_cr = up(event_ts, np.int64), up(creation_ts, np.int64)
    t_vals = up(values, np.float32)
    merge(up(keys, np.int64), t_ev, t_cr, t_vals, up(q_ids, np.int64),
          up(q_ev, np.int64), up(q_vals, np.float32), batch_creation_ts)
    out = t_ev.cpu().numpy(), t_cr.cpu().numpy(), t_vals.cpu().numpy()
    if dev.type == "cuda":
        check_error(dev)
    return out
