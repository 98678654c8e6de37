"""Geo-distribution (paper §2.1 "Regional presence", §3.1.2–3.1.3, §4.1.2).

Two access mechanisms for an asset living in one region, consumed in another:
  * CROSS-REGION ACCESS — data stays where created; remote reads traverse the
    inter-region link (the paper's implemented mechanism).
  * GEO-REPLICATION — assets replicated into consumer regions for local-read
    latency (the paper's road-map mechanism; ruled out where geo-fencing /
    data-compliance forbids it).

On the TPU substrate, regions map to the production mesh's ``pod`` axis
(launch/mesh.py): replication = replicated sharding over ``pod``; cross-
region access = collectives over ``pod``.  This module is the control plane:
placement, replication policy, compliance fencing, health, fail-over, and a
latency cost model so benchmarks can contrast the two mechanisms with the
same numbers a WAN deployment would reason about.

The geo-replication DATA plane lives in core/replication.py: every home
``OnlineStore.merge`` appends its reduced winner rows — and every home
``OfflineStore.merge`` its inserted rows — to a ``ReplicationLog`` (one
monotone sequence spanning both planes, one cursor per replica), an async
applier drains the log into replica stores, and ``GeoPlacement.failover``
here decides WHICH replica gets promoted — the nearest healthy one by this
topology's latency model — after which the applier replays that replica's
un-acked log suffix.  Replay is safe because both planes' merges are
idempotent: Algorithm 2's commutative latest-wins join on (event_ts,
creation_ts) online, full-key insert-if-absent offline.  A failed ex-home
leaves the serving set at promotion (``remove_replica``) and re-enters it
when recovered via ``add_replica`` — the control-plane half of
``GeoFeatureStore.rejoin``'s delta bootstrap.

``GeoTopology`` supports per-link latency overrides (``link_latency_ms``)
on top of the two-tier local/WAN default, so "nearest" is a real choice
between replicas rather than a constant.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence

import numpy as np

from repro_torch.core.keys import KEY_SPACE_BITS, shard_coordinate

__all__ = [
    "ReplicationPolicy",
    "Region",
    "GeoTopology",
    "GeoPlacement",
    "ShardMap",
    "RegionDownError",
    "ComplianceError",
]


class ReplicationPolicy(enum.Enum):
    CROSS_REGION_ACCESS = "cross_region_access"  # paper's current mechanism
    GEO_REPLICATED = "geo_replicated"  # paper's road-map mechanism


class RegionDownError(RuntimeError):
    pass


class ComplianceError(RuntimeError):
    pass


@dataclasses.dataclass
class Region:
    name: str
    healthy: bool = True
    #: geo-fenced regions may not export data (compliance, §4.1.2)
    geo_fenced: bool = False


@dataclasses.dataclass
class GeoTopology:
    """Static latency/bandwidth model between regions (ICI vs DCN tiers).

    ``link_latency_ms`` optionally refines the flat WAN tier with symmetric
    per-pair one-way latencies, e.g. ``{("westus2", "eastus"): 32.0}``;
    pairs not listed fall back to ``cross_region_latency_ms``.
    ``cross_region_gbps`` models WAN link bandwidth so replication shipping
    cost can be charged per byte, not just per message."""

    regions: dict[str, Region]
    local_latency_ms: float = 1.0
    cross_region_latency_ms: float = 60.0
    link_latency_ms: dict[tuple[str, str], float] = dataclasses.field(
        default_factory=dict
    )
    cross_region_gbps: float = 1.0
    #: MEASURED per-link round-trip gauges (EWMA), fed by real carriers
    #: (``core/daemon.py``'s ``SocketChannel`` observes every ack RTT).
    #: Deliberately separate from the static ``latency()`` model: the
    #: deterministic routing/shipping gates price the model, while these
    #: gauges report what the wire actually did.
    measured_rtt_ms: dict[tuple[str, str], float] = dataclasses.field(
        default_factory=dict
    )
    #: EWMA smoothing factor for ``observe_rtt`` (weight of the new sample)
    rtt_alpha: float = 0.2

    def latency(self, src: str, dst: str) -> float:
        if src == dst:
            return self.local_latency_ms
        for pair in ((src, dst), (dst, src)):
            if pair in self.link_latency_ms:
                return self.link_latency_ms[pair]
        return self.cross_region_latency_ms

    def transfer_ms(self, src: str, dst: str, nbytes: int) -> float:
        """Modeled one-way shipping time for ``nbytes``: link latency plus
        serialization at the WAN bandwidth (local transfers are free)."""
        if src == dst:
            return 0.0
        return self.latency(src, dst) + nbytes * 8 / (self.cross_region_gbps * 1e6)

    # -- measured link gauges ---------------------------------------------------
    def observe_rtt(self, src: str, dst: str, rtt_ms: float) -> float:
        """Fold one measured round-trip into the per-link EWMA gauge and
        return the updated estimate.  Purely observational — ``latency()``
        and ``transfer_ms()`` stay on the static model."""
        key = (src, dst)
        prev = self.measured_rtt_ms.get(key)
        est = (
            rtt_ms
            if prev is None
            else prev + self.rtt_alpha * (rtt_ms - prev)
        )
        self.measured_rtt_ms[key] = est
        return est

    def measured_latency(self, src: str, dst: str) -> Optional[float]:
        """The link's measured RTT EWMA, or None when nothing real has
        crossed it yet (symmetric lookup, like ``latency``)."""
        for pair in ((src, dst), (dst, src)):
            if pair in self.measured_rtt_ms:
                return self.measured_rtt_ms[pair]
        return None

    # -- health ----------------------------------------------------------------
    # Health lives on the topology so DETECTED failure (the delivery state
    # machine's DEAD transition, core/replication.py) and operator flips
    # (GeoPlacement.mark_down) drive the same flag read routing checks.
    def mark_down(self, region: str) -> None:
        self.regions[region].healthy = False

    def mark_up(self, region: str) -> None:
        self.regions[region].healthy = True


class GeoPlacement:
    """Placement + replication + fail-over for one feature store's assets."""

    def __init__(
        self,
        topology: GeoTopology,
        home_region: str,
        policy: ReplicationPolicy = ReplicationPolicy.CROSS_REGION_ACCESS,
    ) -> None:
        if home_region not in topology.regions:
            raise ValueError(f"unknown region {home_region}")
        self.topology = topology
        self.home_region = home_region
        self.policy = policy
        self.replicas: set[str] = {home_region}
        self.read_log: list[tuple[str, str, float]] = []  # (from, served_by, ms)

    # -- replication --------------------------------------------------------
    def add_replica(self, region: str) -> None:
        if self.policy is not ReplicationPolicy.GEO_REPLICATED:
            raise ComplianceError("replicas require the GEO_REPLICATED policy (§4.1.2)")
        home = self.topology.regions[self.home_region]
        if home.geo_fenced:
            raise ComplianceError(
                f"region {self.home_region} is geo-fenced; assets may not be "
                f"replicated out (data-compliance, §4.1.2)"
            )
        if region not in self.topology.regions:
            raise ValueError(f"unknown region {region}")
        self.replicas.add(region)

    def remove_replica(self, region: str) -> None:
        """Drop a region from the serving set — e.g. a failed ex-home whose
        store was lost at promotion; it may rejoin later via add_replica."""
        if region == self.home_region:
            raise ValueError("cannot remove the home region")
        self.replicas.discard(region)

    # -- routing ---------------------------------------------------------------
    def route_read(
        self, consumer_region: str, candidates: Optional[list[str]] = None
    ) -> tuple[str, float]:
        """Pick the serving region for a read issued from ``consumer_region``.
        Returns (region, modeled latency ms).  Raises RegionDownError when no
        healthy serving region exists.  ``candidates`` optionally restricts
        the serving set further (the geo data plane passes only IN-SYNC
        replicas); health is always re-checked here."""
        if candidates is None:
            candidates = list(self.replicas)
        candidates = [r for r in candidates if self.topology.regions[r].healthy]
        if not candidates:
            raise RegionDownError(
                f"no healthy replica of store homed in {self.home_region}"
            )
        if consumer_region in candidates:
            serving = consumer_region
        else:
            serving = min(
                candidates,
                key=lambda r: (self.topology.latency(consumer_region, r), r),
            )
        ms = self.topology.latency(consumer_region, serving)
        self.read_log.append((consumer_region, serving, ms))
        return serving, ms

    # -- failure handling (§3.1.2: cross-region resources for HA) ---------------
    def mark_down(self, region: str) -> None:
        self.topology.mark_down(region)

    def mark_up(self, region: str) -> None:
        self.topology.mark_up(region)

    def failover(self) -> Optional[str]:
        """If the home region is down, promote the nearest healthy replica to
        primary — nearest by the topology's latency model from the FAILED
        home (ties broken by name for determinism), so the promoted primary
        keeps write traffic on the cheapest link once the region recovers.
        Returns the new primary (or None if nothing to do).

        This only re-points placement; the data-plane half of a fail-over —
        replaying the promoted replica's un-acked replication-log suffix so
        its store converges to the home's pre-failure state — is
        ``GeoReplicator.promote`` (core/replication.py)."""
        if self.topology.regions[self.home_region].healthy:
            return None
        healthy = [
            r
            for r in self.replicas
            if r != self.home_region and self.topology.regions[r].healthy
        ]
        if not healthy:
            raise RegionDownError("home region down and no healthy replica")
        prev = self.home_region
        self.home_region = min(
            healthy, key=lambda r: (self.topology.latency(prev, r), r)
        )
        return self.home_region


class ShardMap:
    """Hash-range partition of the encoded entity keyspace onto home
    regions — the placement half of active-active multi-home writes.

    ``keys.encode_keys`` mixes every entity key uniformly into
    ``[0, 2**KEY_SPACE_BITS)``; this map cuts that interval into contiguous
    ranges (``bounds`` holds the interior cut points) and assigns each range
    a HOME region (``owners``).  Ownership is a pure function of the encoded
    key — ``searchsorted`` over the fixed bounds — so every writer in every
    region routes a key identically with no placement table to consult.

    The bounds are FIXED at construction; rebalance (region join/leave,
    per-shard failover) only rewrites ``owners`` and bumps ``version``, so
    ownership of every key outside the moved range is stable across any
    sequence of reassignments — the property the shard-routing suite sweeps.
    """

    KEY_SPACE = 1 << KEY_SPACE_BITS

    def __init__(self, bounds: Sequence[int], owners: Sequence[str]) -> None:
        self.bounds = np.asarray(list(bounds), np.uint64)
        self.owners = list(owners)
        if len(self.owners) != len(self.bounds) + 1:
            raise ValueError(
                f"{len(self.bounds)} interior bounds need "
                f"{len(self.bounds) + 1} owners, got {len(self.owners)}"
            )
        if len(self.bounds):
            b = self.bounds.astype(object)
            if min(b) <= 0 or max(b) >= self.KEY_SPACE:
                raise ValueError("bounds must lie strictly inside the keyspace")
            if any(x >= y for x, y in zip(b, b[1:])):
                raise ValueError("bounds must be strictly ascending")
        self.version = 0

    @classmethod
    def even(cls, regions: Sequence[str], num_shards: Optional[int] = None):
        """Equal-width ranges, one per region round-robin (the default:
        ``num_shards == len(regions)`` gives each region exactly one
        range)."""
        regions = list(regions)
        if not regions:
            raise ValueError("need at least one region")
        n = num_shards if num_shards is not None else len(regions)
        if n < 1:
            raise ValueError("need at least one shard")
        step = cls.KEY_SPACE // n
        bounds = [step * i for i in range(1, n)]
        owners = [regions[i % len(regions)] for i in range(n)]
        return cls(bounds, owners)

    @property
    def num_shards(self) -> int:
        return len(self.owners)

    def shard_of(self, keys: np.ndarray) -> np.ndarray:
        """Shard id of each encoded key — one ``searchsorted`` over the
        fixed interior bounds, in the uniform ``keys.shard_coordinate``
        space (raw encoded keys cluster low when ids are small; the
        coordinate never does)."""
        keys = np.asarray(keys, np.int64)
        if len(keys) and keys.min() < 0:
            raise ValueError("shard routing requires encoded (non-negative) keys")
        return np.searchsorted(self.bounds, shard_coordinate(keys), side="right")

    def owner_of(self, shard: int) -> str:
        return self.owners[shard]

    def shard_range(self, shard: int) -> tuple[int, int]:
        """Half-open ``[lo, hi)`` range of one shard, in the
        ``keys.shard_coordinate`` space (the same space ``bounds`` cuts and
        the delta-bootstrap ``key_range`` filter masks on)."""
        lo = int(self.bounds[shard - 1]) if shard > 0 else 0
        hi = (
            int(self.bounds[shard])
            if shard < len(self.bounds)
            else self.KEY_SPACE
        )
        return lo, hi

    def owned_shards(self, region: str) -> list[int]:
        return [i for i, o in enumerate(self.owners) if o == region]

    def regions(self) -> list[str]:
        """Distinct owner regions, in first-shard order."""
        seen: list[str] = []
        for o in self.owners:
            if o not in seen:
                seen.append(o)
        return seen

    def assign(self, shard: int, region: str) -> None:
        """Reassign one range to a new home — the ShardMap cutover step of
        rebalance/per-shard failover.  Bounds never move; only this shard's
        ownership changes."""
        if not 0 <= shard < self.num_shards:
            raise ValueError(f"no shard {shard}")
        self.owners[shard] = region
        self.version += 1

    def split_by_owner(self, keys: np.ndarray) -> dict[str, np.ndarray]:
        """Row indices of ``keys`` grouped by owning region — the write-path
        splitter: each group is the slice the writer applies locally (its
        own region) or forwards to the range's home."""
        shards = self.shard_of(keys)
        out: dict[str, np.ndarray] = {}
        for sid in np.unique(shards):
            region = self.owners[int(sid)]
            idx = np.flatnonzero(shards == sid)
            out[region] = (
                np.concatenate([out[region], idx]) if region in out else idx
            )
        # a region owning several ranges gets ONE slice in arrival order, so
        # the forwarded sub-batch replays the caller's row order exactly
        return {r: np.sort(idx) for r, idx in out.items()}

    def as_dict(self) -> dict:
        return {
            "bounds": [int(b) for b in self.bounds],
            "owners": list(self.owners),
            "version": self.version,
        }
