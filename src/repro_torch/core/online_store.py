"""Online store (paper §3.1.4, §4.5) — the Redis analogue, TPU-hosted.

Semantics reproduced exactly:
  * keeps ONLY the latest record per ID: max(tuple(event_ts, creation_ts));
  * Algorithm 2, online branch:
      - key absent            -> insert
      - new event_ts >  old   -> override
      - new event_ts == old and new creation_ts > old -> override
      - otherwise             -> no-op
  * TTL (§4.5.2 "assuming TTL satisfies"): records expire ``ttl`` ms after
    their creation_timestamp; expired records are invisible to lookups and
    reclaimed by ``sweep``, which recycles the freed slots through
    per-partition free lists so partitions stay bounded under TTL churn.

Layout: the paper's storage-partitioning scheme applied to device memory —
hash-partitioned (P, C) slot tables of int64 keys (the plane the lookup
kernel, kernels/online_lookup, scans), int64 event/creation timestamps, plus
(P, C, D) float32 feature values.

Host-mirror / device-truth protocol
-----------------------------------
The ``kernel`` engine keeps the planes DEVICE-RESIDENT (``DeviceTableState``:
int64 key/timestamp tensors + f32 values on the store's device) and device
memory is the source of truth between kernel merges/lookups:

  * a kernel MERGE plans the batch on host (sorted key index -> slots, exact
    Algorithm-2 tallies from the plan), then applies it with ONE in-place
    compare-and-update scatter (``merge_at_slots``) that rewrites the planes
    in their existing device buffers — traffic is O(batch), never O(P·C·D);
  * a kernel GET runs the CUDA lookup kernel against the resident key
    plane and gathers feature rows + creation_ts planes at the resolved
    slots on device (``gather_rows``) — again O(batch) both ways, with TTL
    expiry computed from device truth, not the host mirror;
  * the host numpy planes become a LAZY MIRROR: ``host_stale`` is set by
    every kernel merge, and any host-side consumer (``dump_all``,
    ``get_record``, ``sweep``, host-path lookups, the ``vector``/``loop``
    engines, ``sync_host_mirrors``) first syncs the mirror — one O(P·C·D)
    pull, amortized across arbitrarily many device-side operations;
  * host MUTATIONS (vector/loop merges, ``sweep``, ``_grow``) sync first and
    then DROP the device state (host becomes sole truth again); the next
    kernel operation re-uploads lazily.  Slot assignment, the sorted key
    index, ``keys_full``, and ``fill`` always live on host (inserts resolve
    there), and inserted keys are scattered into the device planes inside
    the same in-place update.

``transfers`` tallies every host<->device byte the store moves, so tests and
benchmarks can assert the steady-state cycle is O(batch).

Write path — three interchangeable engines, byte-identical end states:
  * ``vector`` (default): core.merge_engine pre-reduces the batch to one
    winner per id (lexsort + segment scan), slots resolve in bulk against
    the sorted index, and inserts/overrides land as numpy scatters.  Exact
    Algorithm-2 ``inserts/overrides/noops`` tallies come from the same
    reduction.
  * ``kernel``: identical host planning, applied to the device-resident
    planes as described above.
  * ``loop``: the retained per-row reference implementation — the
    sequential Algorithm-2 semantics the vector engines are proven against
    (parity tests + old-style benchmark baseline).

Every ``merge`` returns per-batch stats: the Algorithm-2 tallies plus the
touched-slot coordinates AND the reduced winner rows that landed there
(encoded key, winning event_ts, feature row, shared creation_ts) — exactly
the bytes the async geo-replication path (core/replication.py) ships
cross-region.  ``merge_reduced`` is the matching apply side: it merges such
a reduced batch (already-encoded int64 keys, stacked float32 values) through
the same engines, so a replica replaying a shipped batch runs the identical
latest-wins state machine — re-delivery and out-of-order delivery are safe
because Algorithm 2 is an idempotent, commutative join on
(event_ts, creation_ts).  ``merge_listeners`` fire after every successful
merge with (spec, stats); the replication log subscribes there.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch.core.assets import FeatureSetSpec
from repro_torch.core.keys import encode_keys
from repro_torch.core.merge_engine import merge_sorted, plan_online_batch
from repro_torch.core.offline_store import CREATION_TS, EVENT_TS
from repro_torch.core.table import Table
from repro_torch.device import resolve_device
from repro_torch.kernels.online_lookup import ops as lookup_ops
from repro_torch.kernels.online_merge import ops as merge_ops

__all__ = ["DeviceTableState", "MergeStats", "OnlineStore", "o_batch_byte_budget"]

_I32_MAX = np.int32(np.iinfo(np.int32).max)


def o_batch_byte_budget(batch: int, record_bytes: int) -> int:
    """The ONE definition of what 'O(batch)' means for the resident
    protocol's transfer guards (tier-1 bench smoke AND the pytest gate): a
    generous constant multiple of the batch footprint, covering plane
    splits, power-of-two bucket padding, and routing imbalance — while
    staying far below one table round-trip for any real table."""
    return 64 * batch * record_bytes


# the ONE shape-bucketing rule (kernels/online_lookup/ops.pow2_bucket):
# batch uploads are padded to a power of two, so the transfer ledger counts
# the same bytes as the JAX store's bucketed uploads
_bucket = lookup_ops.pow2_bucket


def _nbytes(*arrays) -> int:
    return int(sum(a.size * a.dtype.itemsize for a in arrays))


@dataclasses.dataclass(frozen=True)
class MergeStats:
    """Typed per-batch merge result: exact Algorithm-2 tallies plus the
    reduced winning writes (``touched_*`` parallel arrays, sorted by
    (part, slot)) — the complete reduced batch geo-replication ships.

    Frozen: a merge's outcome is a fact, and several consumers (replication
    listener, serving-cache invalidation, materializer outcome records) read
    the SAME instance.  The one post-hoc annotation — the replication
    listener stamping the log sequence it published under — goes through
    ``annotate_replication_seq`` so the exception is explicit.  Supports
    ``stats["key"]``/``.get`` so dict-era consumers and JSON paths keep
    working, and ``as_dict()`` for bench artifacts."""

    engine: str
    inserts: int
    overrides: int
    noops: int
    creation_ts: int
    touched_parts: np.ndarray
    touched_slots: np.ndarray
    touched_keys: np.ndarray
    touched_event_ts: np.ndarray
    touched_values: np.ndarray
    replication_seq: Optional[int] = None

    def annotate_replication_seq(self, seq: Optional[int]) -> None:
        object.__setattr__(self, "replication_seq", seq)

    def __getitem__(self, key: str):
        try:
            return getattr(self, key)
        except AttributeError:
            raise KeyError(key) from None

    def __contains__(self, key) -> bool:
        # without this, `key in stats` falls back to iterating
        # __getitem__(0), which getattr rejects
        return isinstance(key, str) and hasattr(self, key)

    def get(self, key: str, default=None):
        return getattr(self, key, default)

    def as_dict(self) -> dict:
        return {
            "engine": self.engine,
            "inserts": self.inserts,
            "overrides": self.overrides,
            "noops": self.noops,
            "creation_ts": self.creation_ts,
            "touched_rows": int(len(self.touched_keys)),
            "replication_seq": self.replication_seq,
        }


@dataclasses.dataclass
class DeviceTableState:
    """Device-resident truth for one table.  Keys and timestamps are native
    int64 tensors (the JAX package's int32 (lo, hi) split was a TPU
    workaround; the byte counts are the same)."""

    keys: torch.Tensor  # (P, C) int64, -1 = empty
    event_ts: torch.Tensor  # (P, C) int64
    creation_ts: torch.Tensor  # (P, C) int64
    values: torch.Tensor  # (P, C, D) float32

    def planes(self) -> tuple[torch.Tensor, ...]:
        return (self.keys, self.event_ts, self.creation_ts, self.values)

    def nbytes(self) -> int:
        return sum(p.numel() * p.element_size() for p in self.planes())


@dataclasses.dataclass
class _PartitionedTable:
    keys_full: np.ndarray  # (P, C) int64, -1 = empty (host-side truth)
    event_ts: np.ndarray  # (P, C) int64
    creation_ts: np.ndarray  # (P, C) int64
    values: np.ndarray  # (P, C, D) float32
    fill: np.ndarray  # (P,) int64 next fresh slot per partition
    # sorted key index: idx_keys ascending; idx_part/idx_slot parallel
    idx_keys: np.ndarray  # (K,) int64
    idx_part: np.ndarray  # (K,) int64
    idx_slot: np.ndarray  # (K,) int64
    # per-partition FIFO of slots freed by sweep; consumed before fill so
    # TTL churn recycles capacity instead of growing partitions forever
    free: Optional[list] = None
    # loop-engine slot map, maintained incrementally so the reference
    # baseline pays seed-equivalent O(batch) per merge, not an O(K) rebuild;
    # invalidated whenever a vector/kernel merge or a sweep touches the table
    slot_cache: Optional[dict] = None
    # device-resident planes (kernel engine); None = host is sole truth
    device: Optional[DeviceTableState] = None
    # True = device planes have advanced past the host ev/cr/values mirrors
    host_stale: bool = False


class OnlineStore:
    def __init__(
        self,
        num_partitions: int = 16,
        initial_capacity: int = 256,
        *,
        device: str | torch.device = "cuda",
        merge_engine: str = "vector",
    ):
        if merge_engine not in ("vector", "kernel", "loop"):
            raise ValueError(f"unknown merge engine {merge_engine!r}")
        self.num_partitions = num_partitions
        self.initial_capacity = initial_capacity
        self.device = resolve_device(device)
        self.merge_engine = merge_engine
        self._tables: dict[tuple[str, int], _PartitionedTable] = {}
        self._specs: dict[tuple[str, int], FeatureSetSpec] = {}
        # called as cb(spec, stats) after every merge/merge_reduced that ran;
        # callbacks may annotate ``stats`` (e.g. replication seq numbers)
        self.merge_listeners: list = []
        self.inserts = 0
        self.overrides = 0
        self.noops = 0
        # host<->device traffic ledger (bytes actually moved by the resident
        # protocol; O(batch) in steady state — asserted by tests/benchmarks)
        self.transfers = {
            "h2d_bytes": 0,
            "d2h_bytes": 0,
            "device_uploads": 0,
            "host_syncs": 0,
        }

    # -- lifecycle ----------------------------------------------------------
    def register(self, spec: FeatureSetSpec) -> None:
        key = spec.key
        if key in self._tables:
            return
        p, c, d = self.num_partitions, self.initial_capacity, len(spec.features)
        self._tables[key] = _PartitionedTable(
            keys_full=np.full((p, c), -1, np.int64),
            event_ts=np.zeros((p, c), np.int64),
            creation_ts=np.zeros((p, c), np.int64),
            values=np.zeros((p, c, d), np.float32),
            fill=np.zeros(p, np.int64),
            idx_keys=np.empty(0, np.int64),
            idx_part=np.empty(0, np.int64),
            idx_slot=np.empty(0, np.int64),
            free=[deque() for _ in range(p)],
        )
        self._specs[key] = spec

    def has(self, name: str, version: int) -> bool:
        return (name, version) in self._tables

    def _grow(self, key: tuple[str, int]) -> None:
        t = self._tables[key]
        # capacity changes invalidate the device layout: adopt device truth
        # into the host mirror first, then grow host-side and let the next
        # kernel op re-upload at the new shape
        self._mutate_host(t)
        grow = lambda a, fillv: np.concatenate([a, np.full_like(a, fillv)], axis=1)
        t.keys_full = grow(t.keys_full, -1)
        t.event_ts = grow(t.event_ts, 0)
        t.creation_ts = grow(t.creation_ts, 0)
        t.values = np.concatenate([t.values, np.zeros_like(t.values)], axis=1)

    # -- host-mirror / device-truth protocol --------------------------------
    def _upload(self, a: np.ndarray) -> torch.Tensor:
        """Host array -> a tensor on the store's device that owns its memory
        (on the CPU too: device truth must never alias the host mirror)."""
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, copy=True)

    def _ensure_device(self, t: _PartitionedTable) -> DeviceTableState:
        """Upload the planes once; subsequent kernel ops reuse the resident
        tensors."""
        if t.device is None:
            t.device = DeviceTableState(
                keys=self._upload(t.keys_full),
                event_ts=self._upload(t.event_ts),
                creation_ts=self._upload(t.creation_ts),
                values=self._upload(t.values),
            )
            self.transfers["h2d_bytes"] += _nbytes(
                t.keys_full, t.event_ts, t.creation_ts, t.values
            )
            self.transfers["device_uploads"] += 1
        return t.device

    def _sync_host(self, t: _PartitionedTable) -> None:
        """Refresh the host ev/cr/values mirrors from device truth (lazy:
        no-op unless a kernel merge advanced the device planes).  Key planes
        never need a pull — inserts keep them current on host."""
        if not t.host_stale:
            return
        d = t.device
        # copies: the mirror must stay writable and must not alias device
        # truth (on the CPU ``.cpu().numpy()`` is a view of the tensor)
        t.event_ts = d.event_ts.cpu().numpy().copy()
        t.creation_ts = d.creation_ts.cpu().numpy().copy()
        t.values = d.values.cpu().numpy().copy()
        self.transfers["d2h_bytes"] += _nbytes(t.event_ts, t.creation_ts, t.values)
        self.transfers["host_syncs"] += 1
        t.host_stale = False

    def _mutate_host(self, t: _PartitionedTable) -> None:
        """About to write host planes: adopt device truth, then drop the
        device state so host becomes the sole truth."""
        self._sync_host(t)
        t.device = None

    def sync_host_mirrors(self, name: Optional[str] = None,
                          version: Optional[int] = None) -> None:
        """Force host mirrors up to date: all tables, every version of one
        feature set (``name`` only), or one exact table.  Read-only: the
        device state stays resident and remains truth-equal."""
        for (n, v), t in self._tables.items():
            if name is not None and n != name:
                continue
            if version is not None and v != version:
                continue
            self._sync_host(t)

    def transfer_stats(self) -> dict:
        return dict(self.transfers)

    def reset_transfer_stats(self) -> None:
        for k in self.transfers:
            self.transfers[k] = 0

    def device_state(self, name: str, version: int) -> DeviceTableState:
        """The resident planes (uploading them if needed) — benchmark/test
        accessor for the device-truth side of the protocol."""
        return self._ensure_device(self._tables[(name, version)])

    # -- sorted key index ---------------------------------------------------
    def _index_find(
        self, t: _PartitionedTable, ids: np.ndarray
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """ids (B,) -> (part, slot, found); part/slot are 0 where not found."""
        k = len(t.idx_keys)
        pos = np.searchsorted(t.idx_keys, ids)
        safe = np.minimum(pos, max(k - 1, 0))
        found = (
            (pos < k) & (t.idx_keys[safe] == ids)
            if k
            else np.zeros(len(ids), bool)
        )
        part = np.where(found, t.idx_part[safe] if k else 0, 0)
        slot = np.where(found, t.idx_slot[safe] if k else 0, 0)
        return part, slot, found

    def _index_insert(
        self,
        t: _PartitionedTable,
        new_ids: np.ndarray,
        parts: np.ndarray,
        slots: np.ndarray,
    ) -> None:
        """Bulk-insert (already absent) ids, keeping the index sorted."""
        order = np.argsort(new_ids)  # unique keys: stability irrelevant
        t.idx_keys, t.idx_part, t.idx_slot = merge_sorted(
            [t.idx_keys, t.idx_part, t.idx_slot],
            [new_ids[order], parts[order], slots[order]],
        )

    # -- slot assignment (shared by all engines) ----------------------------
    def _assign_slots(self, key: tuple[str, int], parts_o: np.ndarray) -> np.ndarray:
        """Assign a slot to each to-insert id (``parts_o``: partitions in
        ARRIVAL order).  Per partition, sweep-freed slots are consumed FIFO
        before the fill counter advances — identical to the loop engine's
        per-row pop — growing capacity only for the overflow."""
        t = self._tables[key]
        counts = np.bincount(parts_o, minlength=self.num_partitions)
        nfree = np.array([len(f) for f in t.free], np.int64)
        while (t.fill + np.maximum(counts - nfree, 0)).max() > t.keys_full.shape[1]:
            self._grow(key)
        po = np.argsort(parts_o, kind="stable")
        parts_sorted = parts_o[po]
        rank = np.arange(len(po)) - np.searchsorted(parts_sorted, parts_sorted)
        slots_sorted = np.empty(len(po), np.int64)
        use_free = rank < nfree[parts_sorted]
        consumed = np.minimum(counts, nfree)
        if use_free.any():
            # pop exactly the FIFO prefix each partition consumes — one pass,
            # O(batch), not O(total freed capacity)
            free_flat = np.array(
                [f.popleft() for f, k in zip(t.free, consumed)
                 for _ in range(int(k))],
                np.int64,
            )
            off = np.cumsum(consumed) - consumed
            src = off[parts_sorted[use_free]] + rank[use_free]
            slots_sorted[use_free] = free_flat[src]
        over = ~use_free
        if over.any():
            ps = parts_sorted[over]
            slots_sorted[over] = t.fill[ps] + rank[over] - nfree[ps]
        slots_o = np.empty(len(po), np.int64)
        slots_o[po] = slots_sorted
        t.fill += counts - consumed
        return slots_o

    # -- Algorithm 2, online branch -----------------------------------------
    def merge(
        self,
        spec: FeatureSetSpec,
        frame: Table,
        creation_ts: int,
        *,
        engine: Optional[str] = None,
    ) -> MergeStats:
        """Merge one materialization frame.  Returns per-batch stats: exact
        Algorithm-2 tallies plus the touched-slot coordinates and the reduced
        winner rows that landed there (sorted by (part, slot)) — the reduced
        batch form geo-replication ships."""
        engine = engine or self.merge_engine
        if engine not in ("vector", "kernel", "loop"):
            raise ValueError(f"unknown merge engine {engine!r}")
        self.register(spec)
        if len(frame) == 0:
            return self._empty_stats(engine, len(spec.features), creation_ts)
        ids = encode_keys([frame[c] for c in spec.index_columns])
        event_ts = frame[spec.timestamp_col].astype(np.int64)
        fnames = [f.name for f in spec.features]
        if engine == "loop":
            feats = frame.column_stack(fnames, np.float32)
            stats = self._merge_loop(spec.key, ids, event_ts, feats, creation_ts)
        else:
            stats = self._merge_vector(
                spec.key, ids, event_ts, frame, fnames, creation_ts,
                use_kernel=(engine == "kernel"),
            )
        for cb in self.merge_listeners:
            cb(spec, stats)
        return stats

    def merge_reduced(
        self,
        spec: FeatureSetSpec,
        keys: np.ndarray,
        event_ts: np.ndarray,
        values: np.ndarray,
        creation_ts: int,
        *,
        engine: Optional[str] = None,
    ) -> MergeStats:
        """Apply an already-reduced batch keyed by ENCODED int64 ids — the
        geo-replication apply path (and snapshot-bootstrap path) a replica
        store runs on a shipped ``ReplicatedBatch``.

        ``keys`` are non-negative encoded entity keys exactly as a home
        store's ``merge`` produced them (``touched_keys`` in its stats);
        ``values`` is the (B, len(spec.features)) float32 winner plane.  The
        batch goes through the SAME Algorithm-2 engines as ``merge``, so
        re-delivered or out-of-order batches converge: latest-wins on
        (event_ts, creation_ts) is an idempotent, commutative join."""
        engine = engine or self.merge_engine
        if engine not in ("vector", "kernel", "loop"):
            raise ValueError(f"unknown merge engine {engine!r}")
        self.register(spec)
        keys = np.asarray(keys, np.int64)
        event_ts = np.asarray(event_ts, np.int64)
        values = np.asarray(values, np.float32)
        if values.shape != (len(keys), len(spec.features)):
            raise ValueError(
                f"values plane {values.shape} does not match "
                f"({len(keys)}, {len(spec.features)})"
            )
        if len(keys) and keys.min() < 0:
            raise ValueError("reduced-batch keys must be encoded (non-negative)")
        if len(keys) == 0:
            return self._empty_stats(engine, len(spec.features), creation_ts)
        if engine == "loop":
            stats = self._merge_loop(spec.key, keys, event_ts, values, creation_ts)
        else:
            fnames = [f.name for f in spec.features]
            frame = {n: values[:, j] for j, n in enumerate(fnames)}
            stats = self._merge_vector(
                spec.key, keys, event_ts, frame, fnames, creation_ts,
                use_kernel=(engine == "kernel"),
            )
        for cb in self.merge_listeners:
            cb(spec, stats)
        return stats

    @staticmethod
    def _empty_stats(engine: str, d: int, creation_ts: int) -> MergeStats:
        return MergeStats(
            engine=engine, inserts=0, overrides=0, noops=0,
            creation_ts=int(creation_ts),
            touched_parts=np.empty(0, np.int64),
            touched_slots=np.empty(0, np.int64),
            touched_keys=np.empty(0, np.int64),
            touched_event_ts=np.empty(0, np.int64),
            touched_values=np.zeros((0, d), np.float32),
        )

    def _merge_vector(
        self,
        key: tuple[str, int],
        ids: np.ndarray,
        event_ts: np.ndarray,
        frame: Table,
        fnames: list[str],
        creation_ts: int,
        *,
        use_kernel: bool = False,
    ) -> MergeStats:
        t = self._tables[key]
        t.slot_cache = None
        if use_kernel:
            dev = self._ensure_device(t)
        else:
            # host engine writes host planes: adopt device truth, drop device
            self._mutate_host(t)
            dev = None

        def resolve(uids: np.ndarray):
            part_e, slot_e, found = self._index_find(t, uids)
            resolve.parts, resolve.slots = part_e, slot_e
            if t.host_stale:
                # host mirror is behind device truth: O(batch) coord gather
                g = len(uids)
                gb = _bucket(g)
                p32 = np.zeros(gb, np.int32)
                s32 = np.zeros(gb, np.int32)
                p32[:g] = part_e
                s32[:g] = slot_e
                ev, cr = merge_ops.gather_slot_ts(
                    dev.event_ts, dev.creation_ts,
                    self._upload(p32), self._upload(s32),
                )
                self.transfers["h2d_bytes"] += 2 * gb * 4
                self.transfers["d2h_bytes"] += 4 * gb * 4
                return ev.cpu().numpy()[:g], cr.cpu().numpy()[:g], found
            return t.event_ts[part_e, slot_e], t.creation_ts[part_e, slot_e], found

        plan = plan_online_batch(ids, event_ts, creation_ts, resolve)
        part_e, slot_e = resolve.parts, resolve.slots
        found = ~plan.is_new
        # only winner rows' features ever reach the store — gather those,
        # not the whole batch
        wfeats = np.stack(
            [np.asarray(frame[n], np.float32)[plan.winner_row] for n in fnames],
            axis=1,
        )
        self.inserts += plan.inserts
        self.overrides += plan.overrides
        self.noops += plan.noops

        g = len(plan.uids)
        gpart = np.empty(g, np.int64)
        gslot = np.empty(g, np.int64)
        gpart[found] = part_e[found]
        gslot[found] = slot_e[found]

        new = plan.is_new
        if new.any():
            # slots assigned in ARRIVAL order of each id's first occurrence
            # (identical to the sequential loop's fill-counter behavior)
            ins_ids = plan.uids[new]
            arrival = np.argsort(plan.first_row[new], kind="stable")
            ins_ids_o = ins_ids[arrival]
            parts_o = lookup_ops.partition_of(ins_ids_o, self.num_partitions)
            slots_o = self._assign_slots(key, parts_o)
            t.keys_full[parts_o, slots_o] = ins_ids_o
            self._index_insert(t, ins_ids_o, parts_o, slots_o)
            # map arrival-ordered placements back to unique-id (group) order
            gpart_new = np.empty(len(parts_o), np.int64)
            gslot_new = np.empty(len(parts_o), np.int64)
            gpart_new[arrival] = parts_o
            gslot_new[arrival] = slots_o
            gpart[new] = gpart_new
            gslot[new] = gslot_new

        if use_kernel:
            # a grow inside _assign_slots dropped the device state; re-ensure
            # (fresh upload already carries the just-inserted keys)
            dev = self._ensure_device(t)
            gb = _bucket(g)
            # the upload keeps the bucketed length (and so the ledger's
            # bytes); the pad coords are out of bounds and only the first g
            # rows reach the scatter, which would reject them
            p32 = np.zeros(gb, np.int32)
            s32 = np.full(gb, _I32_MAX, np.int32)
            p32[:g] = gpart
            s32[:g] = gslot
            wkeys = np.zeros(gb, np.int64)
            wkeys[:g] = plan.uids
            isnew = np.zeros(gb, bool)
            isnew[:g] = new
            wev = np.zeros(gb, np.int64)
            wev[:g] = plan.winner_ev
            wf = np.zeros((gb, wfeats.shape[1]), np.float32)
            wf[:g] = wfeats
            cr = np.asarray([creation_ts], np.int64)
            merge_ops.merge_at_slots(
                *dev.planes(),
                self._upload(p32)[:g], self._upload(s32)[:g],
                self._upload(wkeys)[:g], self._upload(isnew)[:g],
                self._upload(wev)[:g], self._upload(cr), self._upload(wf)[:g],
            )
            t.host_stale = True
            self.transfers["h2d_bytes"] += _nbytes(
                p32, s32, wkeys, isnew, wev, cr, wf
            )
        else:
            upd = plan.beat
            p_u, s_u = gpart[upd], gslot[upd]
            t.event_ts[p_u, s_u] = plan.winner_ev[upd]
            t.creation_ts[p_u, s_u] = creation_ts
            t.values[p_u, s_u] = wfeats[upd]

        return self._batch_stats(
            plan.inserts, plan.overrides, plan.noops,
            gpart[plan.beat], gslot[plan.beat],
            plan.uids[plan.beat], plan.winner_ev[plan.beat], wfeats[plan.beat],
            creation_ts, engine="kernel" if use_kernel else "vector",
        )

    @staticmethod
    def _batch_stats(
        ins, ovr, nop, tparts, tslots, tkeys, tev, tvals, creation_ts, *, engine
    ) -> MergeStats:
        """Per-batch stats: Algorithm-2 tallies + the reduced winning writes,
        sorted by (part, slot) — see ``MergeStats``."""
        order = np.lexsort((tslots, tparts))
        return MergeStats(
            engine=engine,
            inserts=int(ins),
            overrides=int(ovr),
            noops=int(nop),
            creation_ts=int(creation_ts),
            touched_parts=np.asarray(tparts, np.int64)[order],
            touched_slots=np.asarray(tslots, np.int64)[order],
            touched_keys=np.asarray(tkeys, np.int64)[order],
            touched_event_ts=np.asarray(tev, np.int64)[order],
            touched_values=np.asarray(tvals, np.float32)[order],
        )

    def _merge_loop(
        self,
        key: tuple[str, int],
        ids: np.ndarray,
        event_ts: np.ndarray,
        feats: np.ndarray,
        creation_ts: int,
    ) -> MergeStats:
        """Retained reference: the per-row sequential Algorithm-2 loop.

        Decision semantics are the original row-at-a-time implementation.
        The slot map is cached on the table and maintained incrementally
        (like the seed's persistent dict) so this baseline costs O(batch)
        per merge; only batch-new ids are merged into the sorted index
        afterwards, so end state is byte-identical to the vector engine's."""
        t = self._tables[key]
        self._mutate_host(t)
        slot_of = t.slot_cache
        if slot_of is None:
            slot_of = {
                int(k): (int(p), int(s))
                for k, p, s in zip(t.idx_keys, t.idx_part, t.idx_slot)
            }
            t.slot_cache = slot_of
        new_ids: list[int] = []
        new_parts: list[int] = []
        new_slots: list[int] = []
        touched: set = set()
        ins = ovr = nop = 0
        parts = lookup_ops.partition_of(ids, self.num_partitions)
        for i in range(len(ids)):
            key_i, ev_i, p = int(ids[i]), int(event_ts[i]), int(parts[i])
            existing = slot_of.get(key_i)
            if existing is None:
                if t.free[p]:
                    slot = int(t.free[p].popleft())
                else:
                    if t.fill[p] >= t.keys_full.shape[1]:
                        self._grow(key)
                    slot = int(t.fill[p])
                    t.fill[p] += 1
                t.keys_full[p, slot] = key_i
                t.event_ts[p, slot] = ev_i
                t.creation_ts[p, slot] = creation_ts
                t.values[p, slot] = feats[i]
                slot_of[key_i] = (p, slot)
                new_ids.append(key_i)
                new_parts.append(p)
                new_slots.append(slot)
                touched.add((p, slot))
                ins += 1
            else:
                pp, slot = existing
                old_ev = int(t.event_ts[pp, slot])
                old_cr = int(t.creation_ts[pp, slot])
                if ev_i > old_ev or (ev_i == old_ev and creation_ts > old_cr):
                    t.event_ts[pp, slot] = ev_i
                    t.creation_ts[pp, slot] = creation_ts
                    t.values[pp, slot] = feats[i]
                    touched.add((pp, slot))
                    ovr += 1
                else:
                    nop += 1
        if new_ids:
            self._index_insert(
                t,
                np.asarray(new_ids, np.int64),
                np.asarray(new_parts, np.int64),
                np.asarray(new_slots, np.int64),
            )
        self.inserts += ins
        self.overrides += ovr
        self.noops += nop
        tp = np.array([c[0] for c in touched], np.int64)
        ts = np.array([c[1] for c in touched], np.int64)
        # host planes are truth after a loop merge: the rows at the touched
        # coords ARE the reduced winners this batch wrote
        return self._batch_stats(
            ins, ovr, nop, tp, ts,
            t.keys_full[tp, ts], t.event_ts[tp, ts], t.values[tp, ts],
            creation_ts, engine="loop",
        )

    # -- reads ----------------------------------------------------------------
    def spec(self, name: str, version: int) -> FeatureSetSpec:
        """The registered spec for one table (KeyError if unknown) — the
        serving front resolves feature width/TTL through this."""
        return self._specs[(name, version)]

    def lookup(
        self,
        name: str,
        version: int,
        id_columns: list[np.ndarray],
        *,
        now: Optional[int] = None,
        use_kernel: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Batched GET.  Returns (values (B, D) float32, found (B,) bool).
        TTL-expired records count as not found.

        ``use_kernel=True`` serves entirely from device truth (the lookup
        kernel over the resident keys + on-device row gather, O(batch)
        traffic); ``use_kernel=False``
        serves from the host mirror, syncing it first if a kernel merge left
        it stale — both paths return byte-identical answers."""
        return self.lookup_encoded(
            name, version, encode_keys(id_columns), now=now, use_kernel=use_kernel
        )[:2]

    def lookup_encoded(
        self,
        name: str,
        version: int,
        ids: np.ndarray,
        *,
        now: Optional[int] = None,
        use_kernel: bool = True,
    ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``lookup`` over ALREADY-ENCODED int64 keys — the serving front's
        dispatch path (it encodes once at admission and coalesces encoded
        keys across callers).  Returns (values (B, D) float32, found (B,)
        bool, creation_ts (B,) int64); ``creation_ts`` is the matched row's
        creation timestamp where found and 0 elsewhere (misses AND
        TTL-expired rows), so a caller caching decoded rows can re-check TTL
        later without another store read.  Both engines return byte-identical
        triples."""
        spec = self._specs[(name, version)]
        t = self._tables[(name, version)]
        ids = np.asarray(ids, np.int64)
        b = len(ids)
        d = t.values.shape[-1]
        if b == 0:
            return (
                np.zeros((0, d), np.float32),
                np.zeros(0, bool),
                np.zeros(0, np.int64),
            )
        ttl = spec.materialization.online_ttl
        if use_kernel:
            dev = self._ensure_device(t)
            routed, part, pos = lookup_ops.route_queries_i64(self.num_partitions, ids)
            slots = lookup_ops.lookup(dev.keys, self._upload(routed)).cpu().numpy()
            self.transfers["h2d_bytes"] += _nbytes(routed)
            self.transfers["d2h_bytes"] += _nbytes(slots)
            got = slots[part, pos]
            found = got >= 0
            bb = _bucket(b)
            p32 = np.zeros(bb, np.int32)
            s32 = np.zeros(bb, np.int32)
            p32[:b] = part
            s32[:b] = np.maximum(got, 0)  # clamp misses; masked below
            vals_d, cr_d = lookup_ops.gather_rows(
                dev.values, dev.creation_ts, self._upload(p32), self._upload(s32)
            )
            self.transfers["h2d_bytes"] += 2 * bb * 4
            self.transfers["d2h_bytes"] += bb * (d * 4 + 8)
            vals = vals_d.cpu().numpy()[:b]
            vals[~found] = 0.0
            cr = cr_d.cpu().numpy()[:b]
            if now is not None and ttl is not None:
                expired = found & (now - cr > ttl)
                found = found & ~expired
                vals[expired] = 0.0
            return vals, found, np.where(found, cr, 0)
        self._sync_host(t)
        vals = np.zeros((b, d), np.float32)
        found = np.zeros(b, bool)
        p, s, hit = self._index_find(t, ids)
        cr = t.creation_ts[p, s]
        if now is not None and ttl is not None:
            hit = hit & ~(now - cr > ttl)
        found[hit] = True
        vals[hit] = t.values[p[hit], s[hit]]
        return vals, found, np.where(found, cr, 0)

    def get_record(
        self, name: str, version: int, id_columns: list[np.ndarray]
    ) -> list[Optional[dict]]:
        """Full records (event/creation ts + features) — used by tests and
        the online→offline bootstrap.  Served from the (synced) host mirror."""
        t = self._tables[(name, version)]
        self._sync_host(t)
        ids = encode_keys(id_columns)
        p, s, hit = self._index_find(t, ids)
        out: list[Optional[dict]] = []
        for i, k in enumerate(ids):
            if not hit[i]:
                out.append(None)
                continue
            out.append(
                {
                    "key": int(k),
                    EVENT_TS: int(t.event_ts[p[i], s[i]]),
                    CREATION_TS: int(t.creation_ts[p[i], s[i]]),
                    "features": t.values[p[i], s[i]].copy(),
                }
            )
        return out

    def dump_all(self, name: str, version: int) -> Table:
        """Everything currently live — the §4.5.5 online→offline bootstrap.
        The sorted key index IS the dump order (ascending id).  Syncs the
        host mirror first: a dump is the one read that genuinely needs every
        plane on host."""
        spec = self._specs[(name, version)]
        t = self._tables[(name, version)]
        self._sync_host(t)
        p, s = t.idx_part, t.idx_slot
        cols: dict[str, np.ndarray] = {
            "__key__": t.idx_keys.copy(),
            EVENT_TS: t.event_ts[p, s],
            CREATION_TS: t.creation_ts[p, s],
        }
        vals = (
            t.values[p, s]
            if len(p)
            else np.zeros((0, len(spec.features)), np.float32)
        )
        for j, f in enumerate(spec.features):
            cols[f.name] = vals[:, j]
        return Table(cols)

    def num_records(self, name: str, version: int) -> int:
        return len(self._tables[(name, version)].idx_keys)

    def sweep(self, name: str, version: int, now: int) -> int:
        """Reclaim TTL-expired slots.  Returns #evicted.  Freed slots are
        tombstoned (keys = -1) AND pushed onto per-partition free lists so
        subsequent inserts recycle them — partitions stay bounded under TTL
        churn instead of leaking capacity."""
        spec = self._specs[(name, version)]
        ttl = spec.materialization.online_ttl
        if ttl is None:
            return 0
        t = self._tables[(name, version)]
        k = len(t.idx_keys)
        if k == 0:
            return 0
        if t.host_stale:
            # expiry probe against device truth at index coords — O(live
            # records) of timestamp planes, NOT a full O(P·C·D) mirror pull;
            # the expensive sync happens only when something actually expires
            kb = _bucket(k)
            p32 = np.zeros(kb, np.int32)
            s32 = np.zeros(kb, np.int32)
            p32[:k] = t.idx_part
            s32[:k] = t.idx_slot
            _, cr_d = merge_ops.gather_slot_ts(
                t.device.event_ts, t.device.creation_ts,
                self._upload(p32), self._upload(s32),
            )
            self.transfers["h2d_bytes"] += 2 * kb * 4
            self.transfers["d2h_bytes"] += 2 * kb * 4
            cr = cr_d.cpu().numpy()[:k]
        else:
            cr = t.creation_ts[t.idx_part, t.idx_slot]
        expired = now - cr > ttl
        if not expired.any():
            return 0
        self._mutate_host(t)
        t.slot_cache = None
        p, s = t.idx_part[expired], t.idx_slot[expired]
        t.keys_full[p, s] = -1
        order = np.lexsort((s, p))  # deterministic FIFO: ascending (part, slot)
        for pi, si in zip(p[order], s[order]):
            t.free[pi].append(int(si))
        t.idx_keys = t.idx_keys[~expired]
        t.idx_part = t.idx_part[~expired]
        t.idx_slot = t.idx_slot[~expired]
        return int(expired.sum())
