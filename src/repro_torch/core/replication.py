"""Async geo-replication of BOTH store planes (paper §2.1, §4.1.2 road map).

The paper's implemented mechanism keeps an asset in its creation region and
pays WAN latency on every remote read; its road-map mechanism replicates the
asset into consumer regions so reads are local.  This module is that road-map
mechanism made concrete for both materialization targets: the paper's store
is only a feature store because the SAME data lands offline (training) and
online (inferencing), so a failover that recovers one plane but not the
other reintroduces exactly the online–offline skew the architecture exists
to prevent.  Both planes ship through one log:

  * ONLINE plane — every ``OnlineStore.merge`` reduces a materialization
    frame to the winning writes it actually applied (encoded key, winning
    event_ts, feature row, one shared creation_ts) and reports them in its
    stats (its shipping unit);
  * OFFLINE plane — every ``OfflineStore.merge`` reports the rows it
    actually INSERTED (post full-key dedup, arrival order): encoded entity
    keys + event_ts flat arrays plus the index/feature columns in native
    dtypes.  Replica-side ``OfflineStore.apply_chunks`` re-runs the same
    full-key dedup, so a replica's shard-chunk set converges to the home's.

Two-plane ``ReplicatedBatch`` protocol
--------------------------------------
A batch tags ``plane="online"|"offline"`` over one shared sequence: the
``ReplicationLog`` is ONE totally-ordered log per home store, and each
replica owns ONE cursor covering both planes — per-replica cursor semantics,
out-of-order ack handling, truncation, and backpressure are plane-agnostic.
``keys``/``event_ts``/``values`` are flat planes for both variants; offline
batches add ``columns`` (index + native-dtype feature arrays, the record-
schema remainder) and leave ``values`` empty.  ``ReplicationLog.lag``
reports a per-plane breakdown on top of the combined counts.

Wire transport (core/wire.py)
-----------------------------
Replica-bound batches do NOT travel as in-process references: every batch a
replica receives — drain, out-of-order ``apply_batch``, delta bootstrap,
failover replay — is serialized into a contiguous wire frame (fixed header
+ length-prefixed dtype-tagged arrays, optional zlib), shipped over the
modeled WAN, and DECODED on the replica side; the replica applies read-only
views of the received buffer, so it can never alias or corrupt publisher
memory.  The log itself stores frozen private copies on ``append`` for the
same reason (an un-shipped batch must survive later in-place mutation of
the publisher's buffers).  ``drain`` coalesces runs of adjacent same-plane
same-table pending batches into one frame per run (one header, one shared
compression stream), while acking each constituent batch by its own seq.
Shipping accounting (``GeoReplicator.shipped``, the monitor's
``replication/shipped_*`` counters) records MEASURED bytes — serialized
raw payload and post-compression wire size — and ``topology.transfer_ms``
prices the wire size, making the per-plane shipped-bytes benchmarks true
transport measurements rather than array-size estimates.

Failure model (delivery state machine, core/channel.py)
-------------------------------------------------------
The hop under ``_ship_frame`` is a pluggable ``Channel``:
``InProcessChannel`` (the default) is perfect and keeps every
deterministic gate unchanged; ``FaultyChannel`` drops, duplicates,
reorders, corrupts, delays, and partitions frames on a seeded
deterministic schedule.  Against either, delivery is AT-LEAST-ONCE:

  * a frame's batches are acked per-seq only after the replica decodes
    (wire CRC verified) and applies them AND the ack path returns inside
    ``DeliveryPolicy.ack_timeout_ms`` — anything else (drop, partition,
    corruption, lost/late ack) leaves them pending for redelivery;
  * redelivery is EXACTLY-ONCE IN EFFECT: the online plane's latest-wins
    merge on (event_ts, creation_ts) and the offline plane's full-key
    insert-if-absent make re-applying a batch a no-op, and
    ``ReplicationLog.is_acked`` per-seq dedup counts (never re-acks) a
    batch that arrives again;
  * each replica link runs a per-replica ``DeliveryState``: after a
    failed drain the link backs off for ``min(cap, base << n-1)`` drain
    ticks plus deterministic per-(replica, n) jitter; after
    ``suspect_after`` consecutive failures the link is SUSPECT, after
    ``dead_after`` it is DEAD — which drives ``topology.mark_down``, so
    read routing and ``failover()`` react to DETECTED failure, not
    manual flips;
  * a DEAD link is re-probed every ``probe_interval`` ticks with a
    zero-batch probe frame; the first success flips it back HEALTHY
    (``topology.mark_up``) and normal draining resumes — or, past
    ``evict_after`` failures, the replica is evicted entirely and
    re-admitted later through the ``rejoin``/delta-bootstrap path
    (``GeoFeatureStore.drain`` auto-probes evicted regions);
  * transfers that MUST complete (bootstrap chunks, promotion replay)
    retry against the channel a bounded number of times and raise
    ``DeliveryError`` when the budget is exhausted — never silent loss.

Log / cursor / replay protocol
------------------------------
``ReplicationLog`` is a bounded, totally-ordered sequence of reduced
batches, appended by listeners on the home stores' ``merge_listeners``.
Each replica owns a CURSOR: the lowest sequence number it has not yet
acknowledged.  The async applier (``GeoReplicator.drain``) ships pending
batches over the modeled WAN link and applies them to the replica stores —
``OnlineStore.merge_reduced`` (the same Algorithm-2 engines the home store
runs) or ``OfflineStore.apply_chunks`` by plane.  Acknowledgements may
arrive out of order (``apply_batch``); the cursor only advances over the
contiguous acknowledged prefix, so lag accounting never under-reports.
``truncate`` drops exactly the prefix below EVERY cursor — an un-acked
batch is never dropped; when the log is full and no prefix is fully
acknowledged, ``append`` raises ``ReplicationLogFull`` (backpressure)
instead of losing data.  The PUBLISHER must never lose a batch either (the
home store has already applied it when the listener fires), so under
backpressure the replicator first degrades to a synchronous drain of every
healthy replica — a drain applies BOTH planes, so mixed-plane tails are
fully accounted before concluding a replica pins the log — and only if a
dead replica still pins the tail does it force-append past capacity —
bounded growth plus a monitor counter, never divergence.

Replay safety is per plane: the online plane relies on Algorithm 2 being an
idempotent, commutative, latest-wins join on (event_ts, creation_ts); the
offline plane relies on full-key (id, event_ts, creation_ts) insert-if-
absent idempotence.  Re-delivering a batch is a no-op, reordered batches
converge, and replaying a suffix that partially overlaps already-applied
writes is safe.  That is what makes fail-over exactly-once in EFFECT with
at-least-once DELIVERY: ``GeoPlacement.failover`` picks the nearest healthy
replica (regions.py), then ``GeoReplicator.promote`` replays that replica's
un-acked suffix, leaving its online store byte-identical and its offline
store chunk-set-identical to the home's pre-failure state.

Delta bootstrap + rejoin lifecycle
----------------------------------
A replica added after data exists bootstraps via ``bootstrap_delta``: its
cursor registers at the CURRENT log head (the snapshot-cut sequence
number), then the home state as of that cut streams over in bounded chunks
(``chunk_rows`` at a time — offline via ``OfflineStore.export_chunks``,
online via creation_ts-grouped slices of the dump), and normal draining
from the cut cursor catches it up.  Batches appended DURING the stream
overlap the snapshot harmlessly (idempotence again), and an interrupted
stream can simply be retried — no chunk is ever applied twice.  The same
path re-admits a recovered ex-home: ``GeoFeatureStore.rejoin(region)`` =
fresh stores + delta bootstrap of both planes + cursor at the cut, so a
region whose stores were lost at promotion rejoins as a first-class
replica instead of being dropped forever.

Multi-home write path & rebalance (active-active)
-------------------------------------------------
``MultiHomeGeoStore`` (core/multihome.py) runs this machinery
ACTIVE-ACTIVE: a ``regions.ShardMap`` hash-partitions the encoded keyspace
into ranges, each range homed in one region, and every region runs its OWN
``GeoReplicator`` + ``ReplicationLog`` with all other regions as replicas.
A write landing anywhere splits by owning range — owned slices merge
locally, foreign slices FORWARD to the range's home — so each row is
published by exactly one log and the delivery machinery above applies per
shard-home log unchanged.

The echo hazard is the new failure mode: every region is simultaneously a
publisher (its own log) and a replica (everyone else's), and replica-side
``merge_reduced`` fires the same ``merge_listeners`` a home merge does.
The shard filter in ``_on_home_merge``/``_on_home_offline_merge`` breaks
the loop: a replicator with a ``shard_map`` publishes ONLY the key slice
its home region owns, so applying another home's batch publishes nothing.
Convergence follows from the same per-plane idempotence as above — all
regions drain to byte-identical online and chunk-set-identical offline
state no matter where the writes landed.

Failover is PER-RANGE: losing a region promotes only its owned ranges —
the dead home's log replays its un-acked suffix into the nearest in-sync
replica (``promote``), the ShardMap reassigns just those ranges, and the
drained-dry log retires; every other range's home is untouched.  Rebalance
(region join/leave) reuses the delta-bootstrap path range-filtered
(``bootstrap_delta(key_range=...)``): drain the source log dry, stream the
moving range, cut the ShardMap over, converge.  The cutover window admits
one bounded echo (an in-flight moved-range batch re-published by the new
owner) — idempotence absorbs it; draining the source dry first makes it
not happen at all.

``GeoFeatureStore`` is the SINGLE-HOME read/write router on top (one home
region, ``shard_map=None``, no write splitting): writes (materialization
ticks, backfills) go to the home region's ``FeatureStore``; online reads
are served by the nearest IN-SYNC replica (replication lag at most
``max_lag_batches``), falling back to the home store; per-replica and
per-plane lag / staleness land in the health monitor.  ``failover()``
re-points BOTH of the home ``FeatureStore``'s planes at the promoted
region's stores, so materialization and training reads resume against the
new primary without skew.  Geo-fenced home regions refuse replication
(``ComplianceError``, §4.1.2) exactly as placement does.  Both routers
implement the one ``facade.StoreFacade`` surface serving, examples, and
benchmarks program against.
"""

from __future__ import annotations

import dataclasses
import zlib
from collections import deque
from typing import Callable, Optional

import numpy as np

from repro_torch.core.assets import FeatureSetSpec
from repro_torch.core.channel import Channel, DeliveryError, InProcessChannel, mix64
from repro_torch.core.featurestore import FeatureStore
from repro_torch.core.offline_store import CREATION_TS, EVENT_TS, OfflineStore
from repro_torch.core.online_store import OnlineStore
from repro_torch.core.keys import shard_coordinate
from repro_torch.core.regions import (
    GeoTopology,
    RegionDownError,
    ReplicationPolicy,
    ShardMap,
)

__all__ = [
    "DEFAULT_COMPRESS_LEVEL",
    "STATE_CODES",
    "DeliveryError",
    "DeliveryPolicy",
    "DeliveryState",
    "GeoFeatureStore",
    "GeoReplicator",
    "LagStats",
    "PlaneLag",
    "PlaneShip",
    "ReplicatedBatch",
    "ReplicationLog",
    "ReplicationLogFull",
    "ShipLedger",
]

#: default zlib level for the wire codec (core/wire.py re-exports it); the
#: constant lives here, not in wire.py, because wire.py imports this module
#: (for ReplicatedBatch) and default-argument values need it at class-body
#: execution time, before the bottom-of-module wire import has run.
#: Level 1 is the throughput sweet spot on merge-batch payloads (random-ish
#: float features + low-entropy keys/timestamps): ~97% of level 6's ratio
#: at ~1/3 the encode cost; 0 disables compression entirely.
DEFAULT_COMPRESS_LEVEL = 1


class ReplicationLogFull(RuntimeError):
    """The log hit capacity and no fully-acknowledged prefix can be
    truncated — backpressure instead of dropping un-acked batches."""


#: delivery-state gauge encoding (``replication/state/{replica}``)
STATE_CODES = {"healthy": 0, "suspect": 1, "dead": 2}


@dataclasses.dataclass(frozen=True)
class DeliveryPolicy:
    """Knobs of the per-replica delivery state machine.

    Time is LOGICAL — drain ticks, not wall-clock — so every threshold is
    deterministic and the chaos suite can gate retry counts exactly.
    ``ack_timeout_ms`` is the one model-time knob: a delivery whose modeled
    latency exceeds it (WAN spike) counts as un-acked even though the
    bytes eventually land, and the replica-side per-seq dedup absorbs the
    resulting redelivery."""

    #: modeled one-way latency above which a delivery counts as un-acked
    ack_timeout_ms: float = 5_000.0
    #: consecutive failures before HEALTHY -> SUSPECT
    suspect_after: int = 2
    #: consecutive failures before -> DEAD (drives topology.mark_down)
    dead_after: int = 5
    #: backoff after the n-th consecutive failure, in drain ticks:
    #: min(backoff_cap, backoff_base << (n-1)) + deterministic jitter
    backoff_base: int = 1
    backoff_cap: int = 16
    #: drain ticks between re-probes of a DEAD link
    probe_interval: int = 4
    #: extra attempts per bootstrap chunk before DeliveryError
    bootstrap_retries: int = 10
    #: forced drain rounds a promotion replay may take before DeliveryError
    promote_rounds: int = 64
    #: consecutive failures before the replica is dropped from the set
    #: entirely (None = never; re-admission goes through rejoin/bootstrap)
    evict_after: Optional[int] = None
    #: bounded in-flight window for pipelined draining over carriers that
    #: support it (``post``/``collect`` — core/daemon.py's SocketChannel):
    #: up to this many encoded frames ride the link un-acked at once, so
    #: encode, socket transfer, and replica apply overlap.  1 serializes
    #: (the in-process behavior); the log's out-of-order ack handling and
    #: per-seq dedup are what make >1 safe.
    inflight_window: int = 8


@dataclasses.dataclass
class DeliveryState:
    """What the publisher knows about one replica link — detected health,
    backoff schedule, and the fault ledger the chaos gates read."""

    status: str = "healthy"
    #: logical clock: +1 per drain pass over this replica
    tick: int = 0
    consecutive_failures: int = 0
    #: drains are deferred while tick < backoff_until
    backoff_until: int = 0
    #: next tick a DEAD link gets a probe frame
    next_probe_tick: int = 0
    retries: int = 0  # batches re-shipped after going un-acked
    timeouts: int = 0  # deliveries with no usable ack
    corrupt_frames: int = 0  # arrivals the wire CRC rejected
    redelivered_batches: int = 0  # already-acked batches that arrived again
    bootstrap_retries: int = 0
    probes: int = 0
    #: highest non-bootstrap seq ever transmitted (retry detection)
    max_seq_sent: int = -1
    #: (tick, from_status, to_status) history
    transitions: list[tuple[int, str, str]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class ReplicatedBatch:
    """One reduced merge batch from either store plane.

    ``plane="online"``: the winning writes a single home online-store merge
    applied, in (part, slot) order as the home store reported them —
    ``values`` is the (G, D) float32 feature plane, ``columns`` is None.

    ``plane="offline"``: the rows a single home offline-store merge actually
    INSERTED (post full-key dedup, arrival order) — ``values`` is empty and
    ``columns`` carries the record-schema remainder (index columns + native-
    dtype feature columns), so the replica rebuilds byte-identical chunks.
    """

    seq: int
    table: tuple[str, int]
    creation_ts: int
    keys: np.ndarray  # (G,) int64 encoded entity keys
    event_ts: np.ndarray  # (G,) int64 winning event_ts per key
    values: np.ndarray  # (G, D) float32 winning feature rows (online plane)
    plane: str = "online"
    columns: Optional[dict[str, np.ndarray]] = None  # offline plane payload

    @property
    def rows(self) -> int:
        return len(self.keys)

    @property
    def nbytes(self) -> int:
        n = self.keys.nbytes + self.event_ts.nbytes + self.values.nbytes
        if self.columns is not None:
            n += sum(v.nbytes for v in self.columns.values())
        return n


def _frozen_copy(a: np.ndarray, dtype=None) -> np.ndarray:
    """Private read-only copy of a caller array: the log must not alias
    live publisher buffers (copy) and nothing downstream may mutate a
    logged batch in place (writeable=False)."""
    out = np.array(a, dtype=dtype, copy=True)
    out.flags.writeable = False
    return out


@dataclasses.dataclass(frozen=True)
class PlaneLag:
    """Un-acked backlog of one store plane (online serving vs offline
    history) toward one replica."""

    batches: int = 0
    rows: int = 0

    def as_dict(self) -> dict:
        return {"batches": self.batches, "rows": self.rows}


@dataclasses.dataclass(frozen=True)
class LagStats:
    """Replication lag of one replica: combined un-acked counts, per-plane
    breakdown, and staleness in clock units.  Frozen — a lag reading is a
    snapshot; the multi-home aggregate extends the schema by SUMMING
    readings across shard-home logs (``__add__``) instead of growing more
    string keys."""

    batches: int = 0
    rows: int = 0
    staleness_ms: int = 0
    oldest_pending_creation_ts: Optional[int] = None
    online: PlaneLag = PlaneLag()
    offline: PlaneLag = PlaneLag()

    @property
    def planes(self) -> dict:
        return {"online": self.online, "offline": self.offline}

    def __add__(self, other: "LagStats") -> "LagStats":
        oldest = [
            t
            for t in (
                self.oldest_pending_creation_ts,
                other.oldest_pending_creation_ts,
            )
            if t is not None
        ]
        return LagStats(
            batches=self.batches + other.batches,
            rows=self.rows + other.rows,
            staleness_ms=max(self.staleness_ms, other.staleness_ms),
            oldest_pending_creation_ts=min(oldest) if oldest else None,
            online=PlaneLag(
                self.online.batches + other.online.batches,
                self.online.rows + other.online.rows,
            ),
            offline=PlaneLag(
                self.offline.batches + other.offline.batches,
                self.offline.rows + other.offline.rows,
            ),
        )

    def as_dict(self) -> dict:
        return {
            "batches": self.batches,
            "rows": self.rows,
            "staleness_ms": self.staleness_ms,
            "oldest_pending_creation_ts": self.oldest_pending_creation_ts,
            "planes": {p: d.as_dict() for p, d in self.planes.items()},
        }


@dataclasses.dataclass
class PlaneShip:
    """Per-plane slice of one replica link's shipping ledger."""

    frames: int = 0
    batches: int = 0
    rows: int = 0
    bytes: int = 0
    raw_bytes: int = 0

    def as_dict(self) -> dict:
        return {
            "frames": self.frames,
            "batches": self.batches,
            "rows": self.rows,
            "bytes": self.bytes,
            "raw_bytes": self.raw_bytes,
        }


@dataclasses.dataclass
class ShipLedger:
    """One replica link's shipping ledger.  ``bytes`` is the TRUE wire size
    (post-compression frame bytes, the size the WAN bandwidth model
    prices); ``raw_bytes`` the serialized payload before compression;
    ``frames`` counts wire messages (a coalesced frame carries several
    batches).  MUTABLE by design — these are running counters charged from
    the transmit/apply paths — unlike the frozen snapshot stats
    (``LagStats``/``MergeStats``)."""

    frames: int = 0
    batches: int = 0
    rows: int = 0
    bytes: int = 0
    raw_bytes: int = 0
    ms: float = 0.0
    online: PlaneShip = dataclasses.field(default_factory=PlaneShip)
    offline: PlaneShip = dataclasses.field(default_factory=PlaneShip)

    def plane(self, name: str) -> PlaneShip:
        if name == "online":
            return self.online
        if name == "offline":
            return self.offline
        raise KeyError(name)

    @property
    def by_plane(self) -> dict:
        return {"online": self.online, "offline": self.offline}

    def as_dict(self) -> dict:
        return {
            "frames": self.frames,
            "batches": self.batches,
            "rows": self.rows,
            "bytes": self.bytes,
            "raw_bytes": self.raw_bytes,
            "ms": self.ms,
            "by_plane": {p: d.as_dict() for p, d in self.by_plane.items()},
        }


class ReplicationLog:
    """Bounded sequence of reduced batches + one cursor per replica.

    A cursor is the lowest un-acknowledged sequence number; acks may land
    out of order, and the cursor advances only over the contiguous prefix.
    """

    def __init__(self, capacity: int = 1024) -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.next_seq = 0
        self.cursors: dict[str, int] = {}
        self._batches: deque[ReplicatedBatch] = deque()
        self._acked_ahead: dict[str, set[int]] = {}

    def __len__(self) -> int:
        return len(self._batches)

    def register_replica(self, name: str, from_seq: Optional[int] = None) -> int:
        """Start tracking a replica.  By default its cursor starts at the
        current head — the caller is responsible for snapshot-bootstrapping
        state appended before registration.  An explicit ``from_seq`` must
        lie between the oldest RETAINED sequence number and the head: a
        cursor past ``next_seq`` (or negative) drives ``pending_count``
        negative and silently passes the in-sync read gate while the
        replica is arbitrarily stale, and a cursor below the truncated
        floor pins pending batches that no longer exist — nothing is
        drainable, so the replica could never catch up (it missed the
        truncated data; it needs a snapshot bootstrap, not a cursor)."""
        if from_seq is not None:
            floor = self._batches[0].seq if self._batches else self.next_seq
            if not (floor <= from_seq <= self.next_seq):
                raise ValueError(
                    f"from_seq {from_seq} outside [{floor}, {self.next_seq}] "
                    f"(cursor may not start past the log head or below the "
                    f"truncated floor)"
                )
        cursor = self.next_seq if from_seq is None else from_seq
        self.cursors[name] = cursor
        self._acked_ahead[name] = set()
        return cursor

    def drop_replica(self, name: str) -> None:
        self.cursors.pop(name, None)
        self._acked_ahead.pop(name, None)

    def pending_count(self, replica: str) -> int:
        """O(1) un-acked batch count — the serving path's in-sync gate."""
        ahead = len(self._acked_ahead[replica])
        return self.next_seq - self.cursors[replica] - ahead

    def append(
        self,
        table: tuple[str, int],
        creation_ts: int,
        keys: np.ndarray,
        event_ts: np.ndarray,
        values: np.ndarray,
        *,
        plane: str = "online",
        columns: Optional[dict[str, np.ndarray]] = None,
        force: bool = False,
    ) -> ReplicatedBatch:
        """Append one reduced batch (either plane — both share the one
        sequence); truncates the fully-acked prefix first and raises
        ``ReplicationLogFull`` rather than evicting un-acked batches when
        the log is still at capacity.  ``force=True`` appends past capacity
        instead of raising — for a publisher whose store ALREADY applied
        the batch, losing it is worse than growing the log (see
        GeoReplicator._publish).

        The logged arrays are private COPIES, frozen read-only: the caller
        hands in live views of its own buffers (an online merge's
        ``touched_values``, an offline merge's ``inserted_columns`` slices
        of the frame), and an un-shipped batch may sit in the log across
        later in-place mutation or compaction of those buffers.  Aliasing
        them would silently corrupt whatever eventually ships."""
        if plane not in ("online", "offline"):
            raise ValueError(f"unknown plane {plane!r}")
        if len(self._batches) >= self.capacity:
            self.truncate()
        if len(self._batches) >= self.capacity and not force:
            slowest = min(self.cursors.values(), default=None)
            msg = f"log at capacity {self.capacity}; slowest cursor {slowest}"
            raise ReplicationLogFull(msg)
        batch = ReplicatedBatch(
            seq=self.next_seq,
            table=table,
            creation_ts=int(creation_ts),
            keys=_frozen_copy(keys, np.int64),
            event_ts=_frozen_copy(event_ts, np.int64),
            values=_frozen_copy(values, np.float32),
            plane=plane,
            columns=(
                None
                if columns is None
                else {k: _frozen_copy(v) for k, v in columns.items()}
            ),
        )
        self.next_seq += 1
        self._batches.append(batch)
        return batch

    def pending(self, replica: str) -> list[ReplicatedBatch]:
        """Batches the replica has not acknowledged, in sequence order."""
        cursor = self.cursors[replica]
        ahead = self._acked_ahead[replica]
        return [b for b in self._batches if b.seq >= cursor and b.seq not in ahead]

    def ack(self, replica: str, seq: int) -> None:
        """Acknowledge one batch; the cursor advances over the contiguous
        acknowledged prefix only, so out-of-order acks never hide lag."""
        if seq >= self.next_seq:
            raise ValueError(f"ack of unknown seq {seq}")
        ahead = self._acked_ahead[replica]
        if seq >= self.cursors[replica]:
            ahead.add(seq)
        while self.cursors[replica] in ahead:
            ahead.remove(self.cursors[replica])
            self.cursors[replica] += 1

    def is_acked(self, replica: str, seq: int) -> bool:
        """Has this replica already acknowledged ``seq``?  Redelivery
        detection for the at-least-once transport: an acked batch arriving
        again is absorbed by per-plane idempotence and counted — never
        re-acked into cursor state."""
        return seq < self.cursors[replica] or seq in self._acked_ahead[replica]

    def truncate(self) -> int:
        """Drop the prefix every replica has acknowledged.  Never touches a
        batch at or above any cursor, so un-acked batches survive.  Returns
        the number of batches dropped."""
        floor = min(self.cursors.values(), default=self.next_seq)
        dropped = 0
        while self._batches and self._batches[0].seq < floor:
            self._batches.popleft()
            dropped += 1
        return dropped

    def lag(self, replica: str) -> LagStats:
        """Un-acked batch/row counts (combined + per plane) and the oldest
        pending creation_ts.  The combined counts are what the in-sync read
        gate consumes; the per-plane breakdown feeds monitoring, so an
        offline-only backlog (e.g. a replica serving reads but behind on
        training history) is visible, not averaged away."""
        pend = self.pending(replica)
        planes = {
            p: PlaneLag(
                batches=sum(1 for b in pend if b.plane == p),
                rows=int(sum(b.rows for b in pend if b.plane == p)),
            )
            for p in ("online", "offline")
        }
        return LagStats(
            batches=len(pend),
            rows=int(sum(b.rows for b in pend)),
            oldest_pending_creation_ts=(
                min(b.creation_ts for b in pend) if pend else None
            ),
            online=planes["online"],
            offline=planes["offline"],
        )


class GeoReplicator:
    """Async applier: drains the home stores' replication log into replica
    stores (both planes) over the modeled WAN, tracks lag, and replays on
    fail-over.

    Every replica-bound batch — drain, out-of-order ``apply_batch``, delta
    bootstrap, failover replay — crosses the WAN hop as a serialized wire
    frame (core/wire.py): encode on the home side, decode on the replica
    side, apply only the decoded copy.  Adjacent same-plane same-table
    pending batches coalesce into one frame per ``drain``; shipping
    accounting records MEASURED raw and post-compression wire bytes, and
    the topology's bandwidth model prices the compressed size.

    The hop itself is a pluggable ``Channel`` and each replica link runs
    the ``DeliveryPolicy``/``DeliveryState`` machine documented in the
    module docstring's failure-model section: at-least-once transmission
    with ack-timeout detection, capped exponential backoff, automatic
    SUSPECT/DEAD health driving ``topology.mark_down``, probe-based
    recovery, and optional eviction.  ``on_evict`` (if given) is called
    with the region name after an evicted replica's state is torn down —
    the control-plane hook ``GeoFeatureStore`` uses to drop placement and
    queue an auto-rejoin."""

    def __init__(
        self,
        home_store: OnlineStore,
        *,
        topology: GeoTopology,
        home_region: str,
        home_offline: Optional[OfflineStore] = None,
        log: Optional[ReplicationLog] = None,
        clock: Optional[Callable[[], int]] = None,
        monitor=None,
        compress_level: Optional[int] = DEFAULT_COMPRESS_LEVEL,
        channel: Optional[Channel] = None,
        policy: Optional[DeliveryPolicy] = None,
        on_evict: Optional[Callable[[str], None]] = None,
        shard_map: Optional[ShardMap] = None,
    ) -> None:
        self.topology = topology
        self.home_region = home_region
        #: multi-home publish filter: when set, the home-merge listeners
        #: publish ONLY the key slice this home's shards own — a replica
        #: applying another home's batch therefore publishes nothing, which
        #: is what keeps the active-active mesh echo-free (module docstring,
        #: "Multi-home write path").  None = single-home, publish everything.
        self.shard_map = shard_map
        self.log = log if log is not None else ReplicationLog()
        self.clock = clock or (lambda: 0)
        self.monitor = monitor
        self.compress_level = compress_level
        self.channel: Channel = (
            channel if channel is not None else InProcessChannel(topology)
        )
        self.policy = policy if policy is not None else DeliveryPolicy()
        self.on_evict = on_evict
        self.delivery: dict[str, DeliveryState] = {}
        self.stores: dict[str, OnlineStore] = {home_region: home_store}
        # offline plane is optional: a standalone online-only replicator
        # (benchmarks, tests) never publishes offline batches
        self.offline_stores: dict[str, OfflineStore] = {}
        # OUT-OF-PROCESS replicas (core/daemon.py): region -> {"offline":
        # bool}.  A remote replica has no entry in ``stores`` — its state
        # lives in the daemon — so read routing and store-walking callers
        # skip it automatically; its per-region carrier lives in
        # ``channels`` (``channel`` stays the default for in-process
        # replicas, preserving every deterministic gate bit for bit).
        self.remote: dict[str, dict] = {}
        self.channels: dict[str, Channel] = {}
        self.shipped: dict[str, dict] = {}
        self._specs: dict[tuple[str, int], FeatureSetSpec] = {}
        home_store.merge_listeners.append(self._on_home_merge)
        if home_offline is not None:
            self.offline_stores[home_region] = home_offline
            home_offline.merge_listeners.append(self._on_home_offline_merge)

    # -- publish (home side) ------------------------------------------------
    def _publish(self, payload: tuple, plane: str, columns=None) -> int:
        """Append one reduced batch to the log, degrading under
        backpressure.  The home store has ALREADY applied this batch by the
        time a listener fires, so the append must never lose it: when the
        log is full, backpressure degrades async replication to a
        synchronous drain of every healthy replica — the drain applies
        BOTH planes, so a mixed online/offline tail is fully accounted
        (cursors advance over every batch, freeing the prefix) before
        concluding that a replica pins the log; only if an UNHEALTHY
        replica still pins the tail is the batch force-appended — the log
        temporarily exceeds capacity (surfaced via the
        ``replication/log_force_appends`` counter) rather than diverging
        the replicas forever."""
        try:
            batch = self.log.append(*payload, plane=plane, columns=columns)
        except ReplicationLogFull:
            for region in self.replica_regions():
                if self.topology.regions[region].healthy:
                    self.drain(region)
            try:
                batch = self.log.append(*payload, plane=plane, columns=columns)
            except ReplicationLogFull:
                batch = self.log.append(
                    *payload, plane=plane, columns=columns, force=True
                )
                if self.monitor is not None:
                    self.monitor.system.inc("replication/log_force_appends")
        return batch.seq

    def _owned_slice(self, keys: np.ndarray) -> Optional[np.ndarray]:
        """Multi-home publish filter: row indices of ``keys`` owned by this
        home's shards, or None when no shard map is set (single-home —
        publish everything).  An all-owned batch returns the full index
        range, a fully-foreign batch (a replica applying another home's
        writes) an empty one."""
        if self.shard_map is None:
            return None
        shards = self.shard_map.shard_of(keys)
        mine = np.array(
            [o == self.home_region for o in self.shard_map.owners], bool
        )
        return np.flatnonzero(mine[shards])

    def _on_home_merge(self, spec: FeatureSetSpec, stats) -> None:
        """Home ONLINE-store merge listener: append the batch's reduced
        winning writes to the log and annotate the stats with the seq.
        Under a shard map, only the home-owned key slice is published
        (``_owned_slice``) — the multi-home echo breaker."""
        self._specs[spec.key] = spec
        keys = stats.get("touched_keys")
        if keys is None or len(keys) == 0:
            stats.annotate_replication_seq(None)  # pure no-op batch
            return
        event_ts = stats["touched_event_ts"]
        values = stats["touched_values"]
        owned = self._owned_slice(keys)
        if owned is not None:
            if len(owned) == 0:
                stats.annotate_replication_seq(None)  # fully-foreign batch
                return
            if len(owned) < len(keys):
                keys = keys[owned]
                event_ts = event_ts[owned]
                values = values[owned]
        payload = (spec.key, stats["creation_ts"], keys, event_ts, values)
        stats.annotate_replication_seq(self._publish(payload, "online"))

    def _on_home_offline_merge(self, spec: FeatureSetSpec, stats: dict) -> None:
        """Home OFFLINE-store merge listener: ship the rows the merge
        actually inserted (post full-key dedup) as an offline-plane batch —
        shard-filtered like the online listener."""
        self._specs[spec.key] = spec
        keys = stats.get("inserted_keys")
        if keys is None or len(keys) == 0:
            stats["replication_seq"] = None  # fully-deduped batch: no-op
            return
        event_ts = stats["inserted_event_ts"]
        columns = stats["inserted_columns"]
        owned = self._owned_slice(keys)
        if owned is not None:
            if len(owned) == 0:
                stats["replication_seq"] = None
                return
            if len(owned) < len(keys):
                keys = keys[owned]
                event_ts = event_ts[owned]
                columns = {k: v[owned] for k, v in columns.items()}
        payload = (
            spec.key,
            stats["creation_ts"],
            keys,
            event_ts,
            np.empty((len(keys), 0), np.float32),
        )
        stats["replication_seq"] = self._publish(
            payload, "offline", columns=columns
        )

    # -- replica membership --------------------------------------------------
    def replica_regions(self) -> list[str]:
        out = [r for r in self.stores if r != self.home_region]
        out.extend(r for r in self.remote if r not in out)
        return out

    def channel_for(self, region: str) -> Channel:
        """The carrier for one replica link — a per-region channel (remote
        replicas) or the shared default."""
        return self.channels.get(region, self.channel)

    def _new_ship_ledger(self) -> ShipLedger:
        return ShipLedger()

    def add_replica(
        self,
        region: str,
        store: OnlineStore,
        offline_store: Optional[OfflineStore] = None,
    ) -> int:
        """Start tracking a replica; its single cursor (both planes) starts
        at the current head — the snapshot-cut sequence number the caller's
        ``bootstrap_delta`` streams state up to.  Returns that cut."""
        if region in self.stores:
            raise ValueError(f"region {region} already has a store")
        # the replica set must be plane-homogeneous: an online-only replica
        # under an offline-publishing home would crash every drain (and, via
        # the backpressure fallback, the home write path) on its first
        # offline batch — and an offline-capable replica under an
        # online-only home would set up the same crash for its siblings the
        # moment promote() makes it the publisher
        home_offline = self.home_region in self.offline_stores
        if offline_store is None and home_offline:
            raise ValueError(
                f"home {self.home_region} replicates the offline plane; "
                f"replica {region} must provide an offline store too"
            )
        if offline_store is not None and not home_offline:
            raise ValueError(
                f"home {self.home_region} does not replicate the offline "
                f"plane; construct GeoReplicator with home_offline or drop "
                f"replica {region}'s offline store"
            )
        self.stores[region] = store
        if offline_store is not None:
            self.offline_stores[region] = offline_store
        cut = self.log.register_replica(region)
        self.delivery[region] = DeliveryState()
        self.shipped[region] = self._new_ship_ledger()
        return cut

    def add_remote_replica(
        self,
        region: str,
        channel: Channel,
        *,
        offline: Optional[bool] = None,
    ) -> int:
        """Start tracking an OUT-OF-PROCESS replica reached over its own
        carrier (core/daemon.py's ``SocketChannel``): frames ship through
        ``channel``, the daemon applies and acks, and the publisher trusts
        the acks instead of applying anything locally.  The replica set
        stays plane-homogeneous with the home (``offline`` defaults to
        whatever the home publishes).  Returns the registration cut, like
        ``add_replica``."""
        if region in self.stores or region in self.remote:
            raise ValueError(f"region {region} already has a store")
        home_offline = self.home_region in self.offline_stores
        if offline is None:
            offline = home_offline
        if not offline and home_offline:
            raise ValueError(
                f"home {self.home_region} replicates the offline plane; "
                f"remote replica {region} must carry it too"
            )
        if offline and not home_offline:
            raise ValueError(
                f"home {self.home_region} does not replicate the offline "
                f"plane; remote replica {region} cannot"
            )
        self.remote[region] = {"offline": bool(offline)}
        self.channels[region] = channel
        # the carrier's own ack wait must not outlast the policy's notion
        # of "timed out", or the state machine would never see timeouts
        if hasattr(channel, "ack_timeout_ms"):
            channel.ack_timeout_ms = float(self.policy.ack_timeout_ms)
        cut = self.log.register_replica(region)
        self.delivery[region] = DeliveryState()
        self.shipped[region] = self._new_ship_ledger()
        return cut

    def bootstrap_delta(
        self,
        region: str,
        spec: FeatureSetSpec,
        *,
        chunk_rows: int = 65_536,
        key_range: Optional[tuple[int, int]] = None,
    ) -> dict:
        """Stream one table's home state AS OF the replica's registration
        cut into the new replica, in bounded ``chunk_rows`` pieces — the
        delta bootstrap: snapshot cut at a log sequence number (the cursor
        ``add_replica`` registered) + normal catch-up draining from that
        cursor.  A late replica therefore never holds a full second copy in
        flight, batches appended during the stream overlap it harmlessly
        (per-plane idempotence), and an interrupted stream is simply
        retried — ``apply_chunks``/``merge_reduced`` make re-application a
        no-op.  Every chunk crosses the WAN as a wire frame (seq = the
        out-of-log ``BOOTSTRAP_SEQ`` sentinel, never acked); offline chunks
        span many merges, so their per-row creation_ts rides along as a
        wire column the apply side peels off.

        ``key_range`` — half-open ``[lo, hi)`` over the uniform
        ``keys.shard_coordinate`` of encoded keys (the space ``ShardMap``
        bounds cut) — streams only that slice of both planes: the
        multi-home rebalance path ("stream the moving range") reuses this
        bootstrap with one shard's ``ShardMap.shard_range`` instead of
        re-shipping whole tables.  Returns per-plane bootstrapped row
        counts."""
        self._specs[spec.key] = spec
        out = {"online_rows": 0, "offline_rows": 0, "chunks": 0}

        def in_range(keys: np.ndarray) -> Optional[np.ndarray]:
            if key_range is None:
                return None
            lo, hi = key_range
            coord = shard_coordinate(keys)
            return (coord >= np.uint64(lo)) & (coord < np.uint64(hi))

        home_online = self.stores[self.home_region]
        store = self.stores.get(region)
        is_remote = region in self.remote
        if (
            (store is not None or is_remote)
            and spec.materialization.online_enabled
            and home_online.has(spec.name, spec.version)
        ):
            if store is not None:
                store.register(spec)
            dump = home_online.dump_all(spec.name, spec.version)
            mask = in_range(dump["__key__"]) if len(dump) else None
            if mask is not None:
                dump = dump.take(np.flatnonzero(mask))
            if len(dump):
                keys = dump["__key__"]
                event_ts = dump[EVENT_TS]
                creation_ts = dump[CREATION_TS]
                values = dump.column_stack([f.name for f in spec.features], np.float32)
                for cr in np.unique(creation_ts):
                    idx = np.flatnonzero(creation_ts == cr)
                    for lo in range(0, len(idx), chunk_rows):
                        sl = idx[lo : lo + chunk_rows]
                        batch = ReplicatedBatch(
                            seq=wire.BOOTSTRAP_SEQ,
                            table=spec.key,
                            creation_ts=int(cr),
                            keys=keys[sl],
                            event_ts=event_ts[sl],
                            values=values[sl],
                        )
                        self._ship_bootstrap(region, batch)
                        out["online_rows"] += len(sl)
                        out["chunks"] += 1
        home_offline = self.offline_stores.get(self.home_region)
        offline = self.offline_stores.get(region)
        remote_offline = is_remote and self.remote[region]["offline"]
        if (
            (offline is not None or remote_offline)
            and home_offline is not None
            and spec.materialization.offline_enabled
            and home_offline.has(spec.name, spec.version)
        ):
            if offline is not None:
                offline.register(spec)
            for chunk in home_offline.export_chunks(
                spec.name, spec.version, max_rows=chunk_rows
            ):
                mask = in_range(chunk["__key__"]) if len(chunk) else None
                if mask is not None:
                    chunk = chunk.take(np.flatnonzero(mask))
                if len(chunk) == 0:
                    continue
                # CREATION_TS stays IN the columns payload: bootstrap chunks
                # span merges, so creation_ts is per-row, not the batch
                # scalar — _ship_frame pops it back out on the replica side
                cols = {
                    k: chunk[k] for k in chunk.names if k not in ("__key__", EVENT_TS)
                }
                batch = ReplicatedBatch(
                    seq=wire.BOOTSTRAP_SEQ,
                    table=spec.key,
                    creation_ts=int(chunk[CREATION_TS][0]),
                    keys=chunk["__key__"],
                    event_ts=chunk[EVENT_TS],
                    values=np.empty((len(chunk), 0), np.float32),
                    plane="offline",
                    columns=cols,
                )
                self._ship_bootstrap(region, batch)
                out["offline_rows"] += len(chunk)
                out["chunks"] += 1
        return out

    def _ship_bootstrap(self, region: str, batch: ReplicatedBatch) -> None:
        """Ship one bootstrap chunk, retrying against the channel: a chunk
        is not a log entry (seq = BOOTSTRAP_SEQ, never acked), so a lost
        one would be lost FOREVER rather than redelivered by the normal
        drain — the stream must therefore push through transient faults or
        fail loudly.  Re-application of a chunk that actually landed is a
        no-op (per-plane idempotence), so blind retry is safe."""
        frame = wire.encode_batch(batch, compress_level=self.compress_level)
        st = self.delivery[region]
        for attempt in range(self.policy.bootstrap_retries + 1):
            if attempt:
                st.bootstrap_retries += 1
            if self._ship_frame(region, frame) is not None:
                return
        raise DeliveryError(
            f"bootstrap chunk for {region} undeliverable after "
            f"{self.policy.bootstrap_retries + 1} attempts"
        )

    # -- apply (replica side) -------------------------------------------------
    def _apply_decoded(self, region: str, batch: ReplicatedBatch) -> dict:
        """Apply ONE decoded batch to the replica's store for its plane.
        Both applies are idempotent (latest-wins online, full-key
        insert-if-absent offline), which is what makes the at-least-once
        channel exactly-once in effect."""
        spec = self._specs[batch.table]
        if batch.plane == "offline":
            cols = dict(batch.columns or {})
            creation = cols.pop(CREATION_TS, batch.creation_ts)
            return self.offline_stores[region].apply_chunks(
                spec, batch.keys, batch.event_ts, creation, cols
            )
        return self.stores[region].merge_reduced(
            spec, batch.keys, batch.event_ts, batch.values, batch.creation_ts
        )

    def _charge_transmit(self, region: str, frame, latency_ms: float) -> None:
        """TRANSMIT-side ledger: the home pays for the send whether or not
        it lands, so retries show up as byte amplification."""
        ship = self.shipped[region]
        ship.frames += 1
        ship.bytes += frame.wire_nbytes
        ship.raw_bytes += frame.raw_nbytes
        ship.ms += latency_ms
        plane = ship.plane(frame.plane)
        plane.frames += 1
        plane.bytes += frame.wire_nbytes
        plane.raw_bytes += frame.raw_nbytes

    def _note_sent_seqs(self, region: str, frame) -> None:
        """Retry detection: any logged seq at or below the high-water mark
        has been transmitted before."""
        st = self.delivery[region]
        resent = sum(
            1
            for s in frame.seqs
            if s != wire.BOOTSTRAP_SEQ and s <= st.max_seq_sent
        )
        if resent:
            st.retries += resent
            if self.monitor is not None:
                self.monitor.record_delivery_retry(region, resent)
        for s in frame.seqs:
            if s != wire.BOOTSTRAP_SEQ and s > st.max_seq_sent:
                st.max_seq_sent = s

    def _announce_tables(self, region: str, frame) -> None:
        """Remote carriers need the table's schema before its first frame
        (specs carry user code that never crosses the wire); idempotent —
        the channel remembers what it has announced."""
        if frame.table == wire.PROBE_TABLE:
            return
        ch = self.channel_for(region)
        ensure = getattr(ch, "ensure_table", None)
        spec = self._specs.get(frame.table)
        if ensure is not None and spec is not None:
            ensure(spec)

    def _absorb_remote(self, region: str, frame, delivery) -> Optional[list[dict]]:
        """Digest a remote carrier's delivery: the replica daemon applied
        the frame itself, so the publisher's whole apply step reduces to
        trusting (or not) the returned ``wire.Ack`` — same contract as the
        in-process path: per-batch stats on success, None on failure (the
        state machine's cue), ledger charged for what the ack proves was
        applied even when the ack itself came back unusable."""
        st = self.delivery[region]
        ack = delivery.remote
        ack_ok = (
            not delivery.ack_lost
            and delivery.latency_ms <= self.policy.ack_timeout_ms
        )
        if ack is None:
            st.timeouts += 1
            if self.monitor is not None:
                self.monitor.record_delivery_fault(region, "timeout")
            return None
        if ack.status == wire.ACK_CORRUPT:
            # the daemon's CRC rejected the frame at its door — the
            # remote mirror of the local corrupt-arrival path
            st.corrupt_frames += 1
            st.timeouts += 1
            if self.monitor is not None:
                self.monitor.record_delivery_fault(region, "corrupt_frame")
                self.monitor.record_delivery_fault(region, "timeout")
            return None
        for s in ack.seqs:
            if s != wire.BOOTSTRAP_SEQ and self.log.is_acked(region, s):
                st.redelivered_batches += 1
                if self.monitor is not None:
                    self.monitor.record_delivery_fault(region, "redelivered")
        if ack_ok:
            for s in ack.seqs:
                if s != wire.BOOTSTRAP_SEQ:
                    self.log.ack(region, s)
        ship = self.shipped[region]
        plane = ship.plane(frame.plane)
        ship.batches += len(ack.seqs)
        ship.rows += ack.rows
        plane.batches += len(ack.seqs)
        plane.rows += ack.rows
        if self.monitor is not None:
            self.monitor.record_replication_ship(
                ack.rows,
                batches=len(ack.seqs),
                raw_nbytes=frame.raw_nbytes,
                wire_nbytes=frame.wire_nbytes,
                plane=frame.plane,
            )
            self.monitor.system.observe(
                f"replication/socket_rtt_ms/{region}", delivery.latency_ms
            )
        if not ack_ok or ack.status != wire.ACK_OK:
            st.timeouts += 1
            if self.monitor is not None:
                self.monitor.record_delivery_fault(region, "timeout")
            return None
        return [{"remote": True, "seq": s} for s in ack.seqs]

    def _ship_frame(self, region: str, frame) -> Optional[list[dict]]:
        """The WAN hop: transmit one encoded ``wire.WireFrame`` over the
        channel, decode and apply every payload that arrives, and ack each
        applied logged seq IF the acknowledgement made it back in time.
        Returns the per-batch apply stats, or None when the delivery
        failed (nothing decodable arrived, or the ack was lost/late) — the
        caller's cue to back off and retry; un-acked batches stay pending.

        For a REMOTE replica the apply happens in the daemon process: the
        carrier returns its ack in ``delivery.remote`` and ``_absorb_remote``
        digests it — the ``DeliveryState`` machine above cannot tell the
        difference.

        Accounting is split by side and is exception-safe: the TRANSMIT
        ledger (frames/bytes/ms) is charged up front — the home pays for
        the send whether or not it lands, so retries show up as byte
        amplification — while the APPLY ledger (batches/rows) is recorded
        in a ``finally`` per batch actually applied, so a replica-side
        apply error mid-frame still accounts the earlier batches it acked
        before the exception propagates."""
        st = self.delivery[region]
        if region in self.remote:
            self._announce_tables(region, frame)
            delivery = self.channel_for(region).transmit(
                self.home_region, region, frame
            )
            self._charge_transmit(region, frame, delivery.latency_ms)
            self._note_sent_seqs(region, frame)
            return self._absorb_remote(region, frame, delivery)
        delivery = self.channel.transmit(self.home_region, region, frame)
        self._charge_transmit(region, frame, delivery.latency_ms)
        self._note_sent_seqs(region, frame)
        ship = self.shipped[region]
        plane = ship.plane(frame.plane)
        ack_ok = (
            not delivery.ack_lost
            and delivery.latency_ms <= self.policy.ack_timeout_ms
        )
        applied: list[dict] = []
        applied_rows = 0
        decoded_any = False
        try:
            for payload in delivery.arrivals:
                try:
                    batches = wire.decode_frame(payload)
                except wire.WireFormatError:
                    # WAN damage caught at the door by the wire CRC — the
                    # frame never touches replica state, no ack returns
                    st.corrupt_frames += 1
                    if self.monitor is not None:
                        self.monitor.record_delivery_fault(region, "corrupt_frame")
                    continue
                decoded_any = True
                for batch in batches:
                    if batch.seq != wire.BOOTSTRAP_SEQ and self.log.is_acked(
                        region, batch.seq
                    ):
                        st.redelivered_batches += 1
                        if self.monitor is not None:
                            self.monitor.record_delivery_fault(region, "redelivered")
                    applied.append(self._apply_decoded(region, batch))
                    applied_rows += batch.rows
                    if ack_ok and batch.seq != wire.BOOTSTRAP_SEQ:
                        self.log.ack(region, batch.seq)
        finally:
            ship.batches += len(applied)
            ship.rows += applied_rows
            plane.batches += len(applied)
            plane.rows += applied_rows
            if self.monitor is not None:
                self.monitor.record_replication_ship(
                    applied_rows,
                    batches=len(applied),
                    raw_nbytes=frame.raw_nbytes,
                    wire_nbytes=frame.wire_nbytes,
                    plane=frame.plane,
                )
        if not decoded_any or not ack_ok:
            st.timeouts += 1
            if self.monitor is not None:
                self.monitor.record_delivery_fault(region, "timeout")
            return None
        return applied

    def apply_batch(self, region: str, batch: ReplicatedBatch) -> dict:
        """Ship + apply ONE batch (either plane) to a replica and
        acknowledge it — a single-batch wire frame, no coalescing.  Exposed
        so tests can drive out-of-order delivery; ``drain`` is the in-order
        coalescing fast path.  Raises ``DeliveryError`` if the channel ate
        the frame (the batch stays pending for a later drain)."""
        frame = wire.encode_batch(batch, compress_level=self.compress_level)
        stats = self._ship_frame(region, frame)
        if not stats:
            raise DeliveryError(f"batch seq {batch.seq} undelivered to {region}")
        return stats[0]

    def _drain_remote_pipelined(
        self, region: str, pend: list[ReplicatedBatch], encoded: dict
    ) -> tuple[int, int, bool, bool]:
        """Drain one REMOTE replica with a bounded in-flight window: keep
        up to ``policy.inflight_window`` encoded frames riding the carrier
        un-acked, absorbing acks as they land, so encode, socket transfer,
        and replica apply overlap instead of serializing.  Safe because
        the log acks out of order (contiguous-prefix cursor advance) and
        the daemon's apply is idempotent per seq — a frame that times out
        mid-window just stays pending and is re-shipped next pass.
        Returns (applied_batches, rows, shipped_any, failed)."""
        ch = self.channel_for(region)
        st = self.delivery[region]
        window = max(1, self.policy.inflight_window)
        runs = wire.coalesce(pend)
        idx = 0
        inflight: dict[int, tuple[object, object]] = {}
        applied_batches = 0
        rows = 0
        shipped_any = False
        failed = False
        while (idx < len(runs) and not failed) or inflight:
            while idx < len(runs) and len(inflight) < window and not failed:
                run = runs[idx]
                idx += 1
                key = (run[0].plane, run[0].table, tuple(b.seq for b in run))
                frame = encoded.get(key)
                if frame is None:
                    frame = wire.encode_run(run, compress_level=self.compress_level)
                    encoded[key] = frame
                self._announce_tables(region, frame)
                self._charge_transmit(region, frame, 0.0)
                self._note_sent_seqs(region, frame)
                token = ch.post(frame)
                if token is None:
                    # the injector ate the send before it hit the socket:
                    # a delivery failure — stop posting new frames but
                    # keep collecting the window already in flight
                    st.timeouts += 1
                    if self.monitor is not None:
                        self.monitor.record_delivery_fault(region, "timeout")
                    failed = True
                else:
                    inflight[id(token)] = (token, frame)
            if not inflight:
                break
            done = ch.collect(self.policy.ack_timeout_ms)
            if not done:
                # nothing completed within the ack timeout: every frame
                # still in flight is charged as timed out and abandoned
                # (a late ack resolves the identical retry next pass)
                for token, _frame in inflight.values():
                    ch.forget(token)
                    st.timeouts += 1
                    if self.monitor is not None:
                        self.monitor.record_delivery_fault(region, "timeout")
                inflight.clear()
                failed = True
                break
            for token, delivery in done:
                entry = inflight.pop(id(token), None)
                if entry is None:
                    continue  # completion for a frame another pass forgot
                _tok, frame = entry
                self.shipped[region].ms += delivery.latency_ms
                stats = self._absorb_remote(region, frame, delivery)
                if stats is None:
                    failed = True
                else:
                    shipped_any = True
                    applied_batches += len(stats)
                    rows += frame.rows
        return applied_batches, rows, shipped_any, failed

    def drain(
        self,
        region: Optional[str] = None,
        max_batches: Optional[int] = None,
        *,
        force: bool = False,
    ) -> dict:
        """Apply pending batches in sequence order — all replicas or one.
        Adjacent same-plane same-table batches coalesce into one wire frame
        (shared header + compression stream); each constituent batch is
        still acked by its own seq.  Replicas whose cursors align get the
        SAME frame — logged batches are immutable, so a run's encoding is
        a pure function of (plane, table, seq range) and is encoded (and
        zlib-compressed) once per drain pass, not once per replica.

        Each pass advances the replica's logical delivery clock by one
        tick.  Unless ``force``d (promotion replay must push through), a
        backing-off link is skipped (``"deferred": "backoff"``) and a DEAD
        link gets a probe at its schedule instead of real frames
        (``"deferred": "dead"``); the first failed frame ends the pass for
        that replica and feeds the state machine.
        Returns {region: {"applied_batches", "applied_rows", ...}}."""
        regions = [region] if region is not None else self.replica_regions()
        out: dict[str, dict] = {}
        encoded: dict[tuple, object] = {}
        for r in regions:
            st = self.delivery[r]
            st.tick += 1
            if not force:
                if st.status == "dead":
                    if st.tick >= st.next_probe_tick:
                        self.probe(r)
                    # the probe may have evicted r, or flipped it healthy
                    if self.delivery.get(r) is None or (
                        self.delivery[r].status == "dead"
                    ):
                        out[r] = {
                            "applied_batches": 0,
                            "applied_rows": 0,
                            "deferred": "dead",
                        }
                        continue
                elif st.tick < st.backoff_until:
                    out[r] = {
                        "applied_batches": 0,
                        "applied_rows": 0,
                        "deferred": "backoff",
                    }
                    self._record_lag(r)
                    continue
            pend = self.log.pending(r)
            if max_batches is not None:
                pend = pend[:max_batches]
            ch = self.channel_for(r)
            if (
                r in self.remote
                and self.policy.inflight_window > 1
                and hasattr(ch, "post")
                and hasattr(ch, "collect")
            ):
                applied_batches, rows, shipped_any, failed = (
                    self._drain_remote_pipelined(r, pend, encoded)
                )
            else:
                rows = 0
                applied_batches = 0
                shipped_any = False
                failed = False
                for run in wire.coalesce(pend):
                    # exact seq tuple, not a (first, last) range:
                    # out-of-order acks can punch holes in one replica's
                    # pending run, and a range key would collide it with
                    # another replica's gapless run over the same span
                    key = (run[0].plane, run[0].table, tuple(b.seq for b in run))
                    frame = encoded.get(key)
                    if frame is None:
                        frame = wire.encode_run(
                            run, compress_level=self.compress_level
                        )
                        encoded[key] = frame
                    stats = self._ship_frame(r, frame)
                    if stats is None:
                        failed = True
                        break
                    shipped_any = True
                    applied_batches += len(stats)
                    rows += frame.rows
            if failed:
                self._record_failure(r)
            elif shipped_any:
                self._record_success(r)
            out[r] = {"applied_batches": applied_batches, "applied_rows": rows}
            if r in self.delivery:  # a failure may have evicted r
                self._record_lag(r)
            else:
                out[r]["evicted"] = True
        self.log.truncate()
        return out

    # -- delivery state machine ------------------------------------------------
    def _set_state(self, region: str, st: DeliveryState, status: str) -> None:
        if st.status == status:
            return
        st.transitions.append((st.tick, st.status, status))
        st.status = status
        if self.monitor is not None:
            self.monitor.record_delivery_state(region, status, STATE_CODES[status])

    def _record_failure(self, region: str) -> None:
        """One failed delivery: schedule capped exponential backoff with
        deterministic per-(replica, streak) jitter, walk the health state
        machine, and — at the DEAD transition — drive ``topology.mark_down``
        so read routing and ``failover()`` react to the DETECTED outage."""
        st = self.delivery[region]
        st.consecutive_failures += 1
        n = st.consecutive_failures
        p = self.policy
        backoff = min(p.backoff_cap, p.backoff_base << min(n - 1, 10))
        # deterministic jitter in [0, backoff): desynchronizes replica
        # retry schedules without any RNG state (chaos runs stay replayable)
        jitter = mix64(zlib.crc32(region.encode()) ^ (n << 1)) % max(backoff, 1)
        st.backoff_until = st.tick + backoff + jitter
        if n >= p.dead_after and st.status != "dead":
            self._set_state(region, st, "dead")
            self.topology.mark_down(region)
            st.next_probe_tick = st.tick + p.probe_interval
            if self.monitor is not None:
                self.monitor.alert(
                    f"replica {region} marked DEAD after {n} consecutive "
                    f"delivery failures"
                )
        elif n >= p.suspect_after and st.status == "healthy":
            self._set_state(region, st, "suspect")
        if (
            p.evict_after is not None
            and n >= p.evict_after
            and region != self.home_region
        ):
            self.evict_replica(region)

    def _record_success(self, region: str) -> None:
        st = self.delivery[region]
        st.consecutive_failures = 0
        st.backoff_until = st.tick
        if st.status != "healthy":
            was_dead = st.status == "dead"
            self._set_state(region, st, "healthy")
            if was_dead:
                # recovery undoes the DETECTED mark_down: the replica is
                # still cursor-tracked, so normal draining catches it up —
                # no bootstrap needed (that path is for EVICTED regions)
                self.topology.mark_up(region)

    def probe(self, region: str) -> bool:
        """Re-probe a DEAD link with a zero-batch probe frame.  Success
        flips the link back HEALTHY (and the region back up); failure
        re-schedules the next probe — and can push the streak over the
        eviction threshold.  Any frames a faulty channel had withheld
        (reorder) ride in with the probe's delivery and are applied."""
        st = self.delivery[region]
        st.probes += 1
        ok = self._ship_frame(region, wire.encode_probe()) is not None
        if ok:
            self._record_success(region)
            return True
        self._record_failure(region)
        st = self.delivery.get(region)  # the failure may have evicted it
        if st is not None:
            st.next_probe_tick = st.tick + self.policy.probe_interval
        return False

    def evict_replica(self, region: str) -> None:
        """Tear down a replica that stayed dead past ``evict_after``: its
        stores, ledger, cursor, and delivery state all go — the log stops
        retaining batches for it, so one unreachable region cannot pin the
        log at capacity forever.  Re-admission is a fresh ``rejoin`` (delta
        bootstrap), and ``on_evict`` lets the control plane react."""
        if region == self.home_region:
            raise ValueError("cannot evict the home region")
        self.stores.pop(region, None)
        self.offline_stores.pop(region, None)
        self.remote.pop(region, None)
        self.channels.pop(region, None)
        self.shipped.pop(region, None)
        self.delivery.pop(region, None)
        self.log.drop_replica(region)
        if self.monitor is not None:
            self.monitor.clear_replica_gauges(region)
            self.monitor.system.inc("replication/evictions")
            self.monitor.alert(f"replica {region} evicted from the serving set")
        if self.on_evict is not None:
            self.on_evict(region)

    # -- lag accounting --------------------------------------------------------
    def lag_batches(self, region: str) -> int:
        """O(1) un-acked batch count — cheap enough for the read hot path
        (the full ``lag`` scans the log for rows/staleness; monitoring
        cadence only)."""
        if region == self.home_region:
            return 0
        return self.log.pending_count(region)

    def lag(self, region: str) -> LagStats:
        """Replication lag of one region: un-acked batches/rows (combined +
        per plane) plus staleness in clock units (0 when fully caught up).
        The home region is by definition in sync."""
        if region == self.home_region:
            return LagStats()
        raw = self.log.lag(region)
        oldest = raw.oldest_pending_creation_ts
        return dataclasses.replace(
            raw,
            staleness_ms=(
                max(0, int(self.clock()) - oldest) if oldest is not None else 0
            ),
        )

    def _record_lag(self, region: str) -> None:
        if self.monitor is not None:
            self.monitor.record_replication_lag(region, self.lag(region))

    # -- fail-over replay -------------------------------------------------------
    def _adopt_remote(self, region: str) -> None:
        """Materialize a remote replica's daemon-held state into fresh
        in-process stores (the ``bootstrap_delta`` rebuild pattern run in
        reverse: dump chunks -> ``merge_reduced``/``apply_chunks``) and
        move the region from the remote set into the local store map.
        ``dump_all`` order is the sorted key index, so the rebuilt online
        store is byte-identical to what an in-process replica would hold;
        offline chunks rebuild through full-key dedup, so the canonical
        history matches chunk-set-identically."""
        ch = self.channels[region]
        home = self.stores[self.home_region]
        store = OnlineStore(
            home.num_partitions,
            home.initial_capacity,
            device=home.device,
            merge_engine=home.merge_engine,
        )
        home_off = self.offline_stores.get(self.home_region)
        off: Optional[OfflineStore] = None
        if self.remote[region]["offline"] and home_off is not None:
            off = OfflineStore(
                home_off.num_shards,
                home_off.time_partition,
                merge_engine=home_off.merge_engine,
                compact_threshold=home_off.compact_threshold,
            )
        for spec in list(self._specs.values()):
            if spec.materialization.online_enabled:
                store.register(spec)
                for b in ch.fetch_dump(spec, "online"):
                    store.merge_reduced(
                        spec, b.keys, b.event_ts, b.values, b.creation_ts
                    )
            if off is not None and spec.materialization.offline_enabled:
                off.register(spec)
                for b in ch.fetch_dump(spec, "offline"):
                    cols = dict(b.columns or {})
                    creation = cols.pop(CREATION_TS, b.creation_ts)
                    off.apply_chunks(spec, b.keys, b.event_ts, creation, cols)
        self.stores[region] = store
        if off is not None:
            self.offline_stores[region] = off
        self.remote.pop(region, None)
        self.channels.pop(region, None)

    def promote(self, region: str) -> dict:
        """Data-plane half of fail-over: replay the promoted replica's
        un-acked log suffix into its stores — BOTH planes (per-plane
        idempotence makes any overlap with already-applied batches a
        no-op) — then make it the new home: its online AND offline merges
        now feed the log for the remaining replicas, whose cursors carry
        over untouched.  The lost ex-home's stores leave the replica set;
        a recovered ex-home rejoins via the delta-bootstrap path
        (``GeoFeatureStore.rejoin``)."""
        if region == self.home_region:
            return {"replayed_batches": 0, "replayed_rows": 0}
        if region not in self.stores and region not in self.remote:
            raise RegionDownError(f"no replica store in {region}")
        # the replay MUST complete — a promoted home missing acked-elsewhere
        # suffix batches would diverge forever — so push through channel
        # faults with forced drains (no backoff deferral, probes bypassed)
        # and fail loudly if the link won't carry the suffix at all
        replay = {"applied_batches": 0, "applied_rows": 0}
        for _ in range(self.policy.promote_rounds):
            got = self.drain(region, force=True)[region]
            replay["applied_batches"] += got["applied_batches"]
            replay["applied_rows"] += got["applied_rows"]
            if self.log.pending_count(region) == 0:
                break
        else:
            raise DeliveryError(
                f"promotion replay for {region} did not converge within "
                f"{self.policy.promote_rounds} forced drains"
            )
        if region in self.remote:
            # the promoted replica's state lives in a daemon process; a
            # home must publish from in-process stores, so adopt the
            # daemon's (now fully converged) state before the swap
            self._adopt_remote(region)
        old_home_region = self.home_region
        old_home = self.stores[self.home_region]
        try:
            old_home.merge_listeners.remove(self._on_home_merge)
        except ValueError:
            pass
        old_offline = self.offline_stores.pop(self.home_region, None)
        if old_offline is not None:
            try:
                old_offline.merge_listeners.remove(self._on_home_offline_merge)
            except ValueError:
                pass
        del self.stores[self.home_region]
        self.log.drop_replica(region)
        self.shipped.pop(region, None)
        self.delivery.pop(region, None)
        self.home_region = region
        if self.monitor is not None:
            # neither region is a replica any more: the promoted one is the
            # new home (in sync by definition), the dead ex-home left the
            # serving set — without this, a departed replica's last lag/
            # staleness gauges would report forever
            self.monitor.clear_replica_gauges(region)
            self.monitor.clear_replica_gauges(old_home_region)
        self.stores[region].merge_listeners.append(self._on_home_merge)
        new_offline = self.offline_stores.get(region)
        if new_offline is not None:
            new_offline.merge_listeners.append(self._on_home_offline_merge)
        return {
            "replayed_batches": replay["applied_batches"],
            "replayed_rows": replay["applied_rows"],
        }


class GeoFeatureStore:
    """Read/write router over a home ``FeatureStore`` plus geo-replicated
    replicas of BOTH store planes.

    Writes (materialization ticks, backfills, direct merges) always land in
    the home region; listeners stream every online merge's reduced batch
    AND every offline merge's inserted rows into the one replication log.
    Online reads route to the nearest IN-SYNC region (lag <=
    ``max_lag_batches``), preferring the consumer's own region — the
    paper's local-read latency win.  ``failover`` composes the placement
    decision (nearest healthy replica) with the log replay that makes the
    promoted region's online store byte-identical and its offline store
    chunk-set-identical to the lost home, then re-points both of the home
    ``FeatureStore``'s planes at the promoted stores.  ``rejoin`` re-admits
    a recovered ex-home through the delta-bootstrap path.
    """

    def __init__(
        self,
        name: str,
        *,
        topology: GeoTopology,
        home_region: str,
        replica_regions: tuple[str, ...] = (),
        max_lag_batches: int = 0,
        log_capacity: int = 1024,
        auto_drain: bool = False,
        compress_level: Optional[int] = DEFAULT_COMPRESS_LEVEL,
        channel: Optional[Channel] = None,
        delivery_policy: Optional[DeliveryPolicy] = None,
        **fs_kwargs,
    ) -> None:
        self.fs = FeatureStore(
            name,
            region=home_region,
            topology=topology,
            replication=ReplicationPolicy.GEO_REPLICATED,
            **fs_kwargs,
        )
        self.topology = topology
        self.placement = self.fs.geo
        self.max_lag_batches = max_lag_batches
        self.auto_drain = auto_drain
        self.log = ReplicationLog(capacity=log_capacity)
        #: regions the delivery state machine evicted; each all-region
        #: drain re-probes them and rejoins the ones whose link came back
        self.evicted: set[str] = set()
        self.replicator = GeoReplicator(
            self.fs.online,
            topology=topology,
            home_region=home_region,
            home_offline=self.fs.offline,
            log=self.log,
            clock=self.fs.clock,
            monitor=self.fs.monitor,
            compress_level=compress_level,
            channel=channel,
            policy=delivery_policy,
            on_evict=self._on_evict,
        )
        self.fs.attach_replication(self.replicator)
        self.last_bootstrap: Optional[dict] = None
        for region in replica_regions:
            self.add_replica(region)

    @property
    def home_region(self) -> str:
        return self.replicator.home_region

    # -- explicit home-store delegation ---------------------------------------
    # (formerly a __getattr__ passthrough: every delegated name is now
    # spelled out, so the geo surface IS the visible API — StoreFacade plus
    # the home store's asset/clock/monitoring handles)
    @property
    def registry(self):
        return self.fs.registry

    @property
    def monitor(self):
        return self.fs.monitor

    @property
    def clock(self):
        return self.fs.clock

    def register_source(self, source) -> None:
        self.fs.register_source(source)

    def create_entity(self, entity):
        return self.fs.create_entity(entity)

    def advance_clock(self, to: int) -> None:
        self.fs.advance_clock(to)

    def check_consistency(self, name: str, version: int):
        return self.fs.check_consistency(name, version)

    def get_offline_features(self, *args, **kwargs):
        return self.fs.get_offline_features(*args, **kwargs)

    # -- membership ----------------------------------------------------------
    def add_replica(self, region: str, *, chunk_rows: int = 65_536) -> OnlineStore:
        """Create a two-plane replica in ``region``: compliance-check
        placement, clone both home stores' configuration, delta-bootstrap
        every table (snapshot cut at the registered cursor, streamed in
        bounded ``chunk_rows`` pieces), and start cursor-tracking new
        batches.  Returns the replica's online store; bootstrap stats land
        in ``last_bootstrap``."""
        self.placement.add_replica(region)  # ComplianceError when geo-fenced
        home = self.fs.online
        home_off = self.fs.offline
        store = OnlineStore(
            num_partitions=home.num_partitions,
            initial_capacity=home.initial_capacity,
            device=home.device,
            merge_engine=home.merge_engine,
        )
        offline = OfflineStore(
            num_shards=home_off.num_shards,
            time_partition=home_off.time_partition,
            merge_engine=home_off.merge_engine,
            compact_threshold=home_off.compact_threshold,
        )
        cut = self.replicator.add_replica(region, store, offline)
        totals = {"cut_seq": cut, "online_rows": 0, "offline_rows": 0, "chunks": 0}
        for n, v in self.fs.registry.list_feature_sets():
            spec = self.fs.registry.get_feature_set(n, v)
            got = self.replicator.bootstrap_delta(region, spec, chunk_rows=chunk_rows)
            for k in ("online_rows", "offline_rows", "chunks"):
                totals[k] += got[k]
        self.last_bootstrap = totals
        return store

    def rejoin(self, region: str, *, chunk_rows: int = 65_536) -> dict:
        """Re-admit a recovered ex-home (or any previously-dropped region)
        as a replica: fresh stores, delta bootstrap of BOTH planes, cursor
        at the snapshot cut — the reverse of failover's prune, so a region
        whose stores were lost at promotion returns to the serving set
        instead of being gone forever.  Requires the region healthy again
        (``mark_up``).  Returns the bootstrap stats."""
        if region not in self.topology.regions:
            raise ValueError(f"unknown region {region}")
        if not self.topology.regions[region].healthy:
            raise RegionDownError(f"region {region} is still down; mark_up first")
        if region in self.replicator.stores:
            raise ValueError(f"region {region} is already in the serving set")
        self.add_replica(region, chunk_rows=chunk_rows)
        return {"rejoined": region, **self.last_bootstrap}

    # -- asset management ------------------------------------------------------
    def create_feature_set(self, spec: FeatureSetSpec) -> FeatureSetSpec:
        """Register with the home store, then pre-register the (empty)
        tables on every replica — both planes — so a relaxed-staleness read
        can serve before the first batch arrives."""
        spec = self.fs.create_feature_set(spec)
        for region in self.replicator.replica_regions():
            if spec.materialization.online_enabled:
                self.replicator.stores[region].register(spec)
            offline = self.replicator.offline_stores.get(region)
            if offline is not None and spec.materialization.offline_enabled:
                offline.register(spec)
        return spec

    # -- writes (home region) -------------------------------------------------
    def tick(self, now: Optional[int] = None) -> dict[str, int]:
        stats = self.fs.tick(now)
        if self.auto_drain:
            self.drain()
        return stats

    def backfill(self, name: str, version: int, start: int, end: int) -> dict:
        stats = self.fs.backfill(name, version, start, end)
        if self.auto_drain:
            self.drain()
        return stats

    def write_batch(
        self,
        name: str,
        version: int,
        frame,
        *,
        creation_ts: Optional[int] = None,
        region: Optional[str] = None,
    ) -> dict:
        """Facade write surface: single-home geo — every write lands in the
        home region regardless of where it originated (``region`` must be
        the home when given; multi-home splitting is ``MultiHomeGeoStore``)."""
        if region is not None and region != self.home_region:
            raise ValueError(
                f"single-home geo store writes land in {self.home_region}; "
                f"got region={region!r} (want MultiHomeGeoStore?)"
            )
        stats = self.fs.write_batch(name, version, frame, creation_ts=creation_ts)
        if self.auto_drain:
            self.drain()
        return stats

    def drain(self, region: Optional[str] = None) -> dict:
        out = self.replicator.drain(region)
        if region is None:
            # evicted regions are no longer cursor-tracked, so the normal
            # probe path can't see them — re-probe here and rejoin (delta
            # bootstrap) the ones whose link carries bytes again
            for r in sorted(self.evicted):
                if self._try_rejoin(r):
                    out[r] = {
                        "applied_batches": 0,
                        "applied_rows": 0,
                        "rejoined": True,
                    }
        return out

    def _try_rejoin(self, region: str) -> bool:
        """One recovery attempt for an evicted region: probe the link with
        a zero-batch frame; if the probe lands, re-admit through the full
        ``rejoin`` delta bootstrap.  A bootstrap that dies against a
        still-flaky link rolls membership back (the region stays evicted)
        and the next drain tries again."""
        rep = self.replicator
        d = rep.channel.transmit(self.home_region, region, wire.encode_probe())
        decoded = False
        for payload in d.arrivals:
            try:
                wire.decode_frame(payload)
                decoded = True
            except wire.WireFormatError:
                pass
        if d.ack_lost or d.latency_ms > rep.policy.ack_timeout_ms or not decoded:
            return False
        self.mark_up(region)
        self.evicted.discard(region)
        try:
            self.rejoin(region)
        except DeliveryError:
            rep.evict_replica(region)  # rolls back via the on_evict hook
            self.mark_down(region)
            return False
        return True

    def recover(self, region: str) -> dict:
        """Manually re-admit an evicted region (the automatic path runs on
        every all-region ``drain``).  Raises ``DeliveryError`` if the link
        still won't carry the bootstrap."""
        if region not in self.evicted:
            raise ValueError(f"region {region} is not evicted")
        self.mark_up(region)
        self.evicted.discard(region)
        try:
            return self.rejoin(region)
        except DeliveryError:
            self.replicator.evict_replica(region)
            self.mark_down(region)
            raise

    def lag(self, region: str) -> LagStats:
        return self.replicator.lag(region)

    # -- reads (nearest in-sync region) ----------------------------------------
    def route_read(
        self, consumer_region: str, *, max_lag_batches: Optional[int] = None
    ) -> tuple[str, float]:
        """Pick the serving region for ``consumer_region``: the consumer's
        own region when it hosts an in-sync healthy store, else the
        nearest in-sync healthy one (home is always in sync).  The sync
        gate is an O(1) cursor-distance check; nearest-healthy selection
        and read-log bookkeeping delegate to placement.  Returns (region,
        modeled one-way latency ms)."""
        max_lag = self.max_lag_batches if max_lag_batches is None else max_lag_batches
        rep = self.replicator
        in_sync = [r for r in rep.stores if rep.lag_batches(r) <= max_lag]
        return self.placement.route_read(consumer_region, candidates=in_sync)

    def get_online_features(
        self,
        name: str,
        version: int,
        id_columns: list[np.ndarray],
        *,
        consumer_region: Optional[str] = None,
        use_kernel: bool = True,
        max_lag_batches: Optional[int] = None,
    ) -> tuple[np.ndarray, np.ndarray, dict]:
        """Geo-routed online GET.  Returns (values, found, route) where
        ``route`` records the serving region and the modeled latency the
        read paid — the number the geo benchmark contrasts across
        mechanisms."""
        consumer = consumer_region or self.home_region
        serving, ms = self.route_read(consumer, max_lag_batches=max_lag_batches)
        vals, found = self.replicator.stores[serving].lookup(
            name, version, id_columns, now=self.fs.clock(), use_kernel=use_kernel
        )
        self.fs.monitor.system.observe("geo/read_modeled_ms", ms)
        return vals, found, {"region": serving, "modeled_ms": ms}

    # -- failure handling --------------------------------------------------------
    def _on_evict(self, region: str) -> None:
        """Replicator eviction hook: drop the region from placement's
        serving set and queue it for the auto-rejoin probe in ``drain``."""
        if region != self.placement.home_region:
            self.placement.remove_replica(region)
        self.evicted.add(region)

    def mark_down(self, region: str) -> None:
        self.placement.mark_down(region)

    def mark_up(self, region: str) -> None:
        self.placement.mark_up(region)

    def failover(self, region: Optional[str] = None) -> Optional[dict]:
        """Promote the nearest healthy replica when the home region is down:
        placement re-points (regions.py), the replicator replays the
        promoted replica's un-acked suffix — BOTH planes — and the home
        ``FeatureStore`` adopts the promoted stores as its online AND
        offline planes, so materialization and training reads resume
        against the new primary without offline/online skew.  The dead
        ex-home leaves the serving set entirely (its stores are gone; a
        LATER failover must never promote it) — if it recovers, ``rejoin``
        re-admits it via delta bootstrap.  Returns promotion info, or None
        when the home region is healthy.

        ``region`` (facade surface) names the lost region; a single-home
        store only ever loses its home, so anything else is an error."""
        old_home = self.home_region
        if region is not None and region != old_home:
            raise ValueError(
                f"single-home geo store can only fail over its home "
                f"{old_home}; got {region!r}"
            )
        new_home = self.placement.failover()
        if new_home is None:
            return None
        replay = self.replicator.promote(new_home)
        self.placement.remove_replica(old_home)
        promoted = self.replicator.stores[new_home]
        self.fs.online = promoted
        self.fs.materializer.online = promoted
        promoted_offline = self.replicator.offline_stores.get(new_home)
        if promoted_offline is not None:
            self.fs.offline = promoted_offline
            self.fs.materializer.offline = promoted_offline
        return {"promoted": new_home, **replay}


# Imported at the BOTTOM: wire.py needs ReplicatedBatch (and the compression
# default) from this module, so importing it any earlier would be circular.
# By the time any GeoReplicator method dereferences `wire`, both modules are
# fully initialized regardless of which one a caller imported first.
from repro_torch.core import wire  # noqa: E402
