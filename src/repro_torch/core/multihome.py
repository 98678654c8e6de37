"""Active-active multi-home writes over sharded key ranges (§4.1.2 endgame).

``GeoFeatureStore`` is a single-home router: every write lands in one
region and fans out.  ``MultiHomeGeoStore`` makes EVERY region a write
home for part of the keyspace instead:

- A ``ShardMap`` (core/regions.py) hash-partitions the encoded entity
  keyspace into contiguous ranges, each owned by one home region.
  Ownership is a pure function of the key, so every entry region splits a
  write batch identically with no coordination.
- Each region is a full two-plane cell (OnlineStore + OfflineStore) AND a
  publisher: one ``GeoReplicator`` + ``ReplicationLog`` per region, with
  every other region as a replica.  A write entering region R splits by
  owning shard; the R-owned slice applies locally, foreign slices forward
  to their shard-homes (modeled one-way WAN charge, counted by the
  forwarded-write gauges).  Each home's merge listeners then publish ONLY
  its owned slice (``GeoReplicator._owned_slice``), which is what keeps
  the full mesh echo-free: a replica applying another home's batch
  publishes nothing.
- Reads split the query ids by range and route each range independently
  to the nearest IN-SYNC replica of that range's home (the home itself is
  always in sync); the modeled latency of the GET is the max over ranges,
  as the fan-out legs run concurrently.
- ``failover(region)`` is PER-SHARD: only the lost region's ranges move —
  ``GeoReplicator.promote`` replays the un-acked suffix into the nearest
  in-sync replica, the ShardMap reassigns just those ranges, and every
  other home keeps serving its own ranges untouched.  The promoted
  replicator is RETIRED (its publish listeners detach — the new owner's
  own replicator publishes for the reassigned ranges now) and kept only
  until its residual suffix drains to the surviving replicas.
- ``rejoin``/``join_region`` admit a (re)joining region by streaming each
  home's owned ranges over the delta-bootstrap path
  (``bootstrap_delta(key_range=...)``); ``rebalance`` moves one range:
  drain the source log DRY (so no in-flight batch published under the old
  ownership races the cutover), stream the moving range, cut the ShardMap
  over.  Convergence after any of this is the usual property: drained
  online stores are byte-identical, offline stores chunk-set-identical,
  at every region.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.assets import FeatureSetSpec
from repro_torch.core.channel import Channel, DeliveryError
from repro_torch.core.keys import encode_keys
from repro_torch.core.monitoring import HealthMonitor
from repro_torch.core.offline_store import OfflineStore
from repro_torch.core.online_store import OnlineStore
from repro_torch.core.regions import (
    GeoTopology,
    Region,
    RegionDownError,
    ShardMap,
)
from repro_torch.core.replication import (
    DEFAULT_COMPRESS_LEVEL,
    DeliveryPolicy,
    GeoReplicator,
    LagStats,
    ReplicationLog,
)
from repro_torch.core.table import Table

__all__ = ["MultiHomeGeoStore"]


class MultiHomeGeoStore:
    """Unified store front (``facade.StoreFacade``) over an active-active
    mesh of per-region cells.  Writes enter at ANY region and split by
    owning shard; reads compose per-range in-sync routing; failover and
    rebalance move individual ranges, not whole stores."""

    def __init__(
        self,
        name: str,
        *,
        topology: GeoTopology,
        regions: Sequence[str],
        shard_map: Optional[ShardMap] = None,
        num_shards: Optional[int] = None,
        max_lag_batches: int = 0,
        log_capacity: int = 1024,
        auto_drain: bool = False,
        compress_level: Optional[int] = DEFAULT_COMPRESS_LEVEL,
        channel: Optional[Channel] = None,
        delivery_policy: Optional[DeliveryPolicy] = None,
        offline_shards: int = 4,
        online_partitions: int = 16,
        device: str | torch.device = "cuda",
        merge_engine: str = "vector",
        clock: Optional[Callable[[], int]] = None,
    ) -> None:
        regions = list(regions)
        if len(regions) < 2:
            raise ValueError("multi-home needs at least two regions")
        self.name = name
        self.topology = topology
        for r in regions:
            topology.regions.setdefault(r, Region(r))
        self.shard_map = (
            shard_map
            if shard_map is not None
            else ShardMap.even(regions, num_shards)
        )
        unknown = set(self.shard_map.owners) - set(regions)
        if unknown:
            raise ValueError(f"shard map owners {sorted(unknown)} not in regions")
        self.max_lag_batches = max_lag_batches
        self.auto_drain = auto_drain
        self.monitor = HealthMonitor()
        self._now = 0
        self.clock = clock or (lambda: self._now)
        self._store_cfg = {
            "online_partitions": online_partitions,
            "offline_shards": offline_shards,
            "device": device,
            "merge_engine": merge_engine,
        }
        self._log_capacity = log_capacity
        self._compress_level = compress_level
        self._channel = channel
        self._policy = delivery_policy
        self._specs: dict[tuple[str, int], FeatureSetSpec] = {}
        self.online: dict[str, OnlineStore] = {}
        self.offline: dict[str, OfflineStore] = {}
        #: one publisher per home; its log carries ONLY that home's owned
        #: slices (the listeners' shard filter), so per-home-log accounting
        #: (ship ledgers, lag) IS per-shard-group accounting
        self.replicators: dict[str, GeoReplicator] = {}
        #: failed-over publishers still draining their residual suffix to
        #: the surviving replicas; entries are {"label": dead_region,
        #: "rep": GeoReplicator} and drop off once dry
        self.retired: list[dict] = []
        #: running write-entry accounting (forwarded fraction is the
        #: multi-home bench gate)
        self.write_log = {"rows": 0, "local_rows": 0, "forwarded_rows": 0}
        for r in regions:
            self._new_cell(r)
        for h in regions:
            rep = self.replicators[h]
            for r in regions:
                if r != h:
                    rep.add_replica(r, self.online[r], self.offline[r])
        self.monitor.record_shard_ownership(self.shard_map.owners)

    # -- cell plumbing -------------------------------------------------------
    def _new_stores(self) -> tuple[OnlineStore, OfflineStore]:
        cfg = self._store_cfg
        online = OnlineStore(
            num_partitions=cfg["online_partitions"],
            device=cfg["device"],
            merge_engine=cfg["merge_engine"],
        )
        offline = OfflineStore(
            num_shards=cfg["offline_shards"],
            merge_engine=cfg["merge_engine"],
        )
        return online, offline

    def _new_cell(self, region: str) -> None:
        online, offline = self._new_stores()
        for spec in self._specs.values():
            if spec.materialization.online_enabled:
                online.register(spec)
            if spec.materialization.offline_enabled:
                offline.register(spec)
        self.online[region] = online
        self.offline[region] = offline
        self._new_cell_replicator(region)

    def _all_replicators(self) -> list[GeoReplicator]:
        return list(self.replicators.values()) + [
            entry["rep"] for entry in self.retired
        ]

    # -- clock / assets ------------------------------------------------------
    def advance_clock(self, to: int) -> None:
        self._now = max(self._now, to)

    def regions(self) -> list[str]:
        """Active home regions, construction order."""
        return list(self.replicators)

    def create_feature_set(self, spec: FeatureSetSpec) -> FeatureSetSpec:
        """Register one feature set on every cell — both planes — so any
        region can apply local slices and serve relaxed reads immediately."""
        self._specs[spec.key] = spec
        for r in self.replicators:
            if spec.materialization.online_enabled:
                self.online[r].register(spec)
            if spec.materialization.offline_enabled:
                self.offline[r].register(spec)
        return spec

    # -- writes (any region) -------------------------------------------------
    def write_batch(
        self,
        name: str,
        version: int,
        frame: Table,
        *,
        creation_ts: Optional[int] = None,
        region: Optional[str] = None,
    ) -> dict:
        """Multi-home ingest: the batch enters at ``region`` (default: the
        first home), splits by owning shard, applies the locally-owned
        slice in place and forwards each foreign slice to its shard-home
        (modeled one-way WAN hop, gauged).  Every slice lands at its OWN
        home, so each home's replication log carries it out to the mesh —
        no write ever applies first at a non-owner."""
        spec = self._specs[(name, version)]
        if region is None:
            region = next(iter(self.replicators))
        if region not in self.replicators:
            raise RegionDownError(f"region {region!r} is not an active home")
        creation = int(self.clock()) if creation_ts is None else int(creation_ts)
        ids = encode_keys([frame[c] for c in spec.index_columns])
        split = self.shard_map.split_by_owner(ids)
        out: dict = {
            "rows": len(frame),
            "creation_ts": creation,
            "region": region,
            "slices": {},
            "forwarded_rows": 0,
        }
        for owner in sorted(split):
            idx = split[owner]
            sub = frame if len(idx) == len(frame) else frame.take(idx)
            if spec.materialization.offline_enabled:
                self.offline[owner].merge_with_stats(spec, sub, creation)
            if spec.materialization.online_enabled:
                self.online[owner].merge(spec, sub, creation)
            out["slices"][owner] = int(len(idx))
            if owner != region:
                out["forwarded_rows"] += int(len(idx))
                self.monitor.record_forwarded_write(region, owner, int(len(idx)))
                self.monitor.system.observe(
                    "multihome/forward_ms", self.topology.latency(region, owner)
                )
        self.write_log["rows"] += len(frame)
        self.write_log["local_rows"] += out["slices"].get(region, 0)
        self.write_log["forwarded_rows"] += out["forwarded_rows"]
        if self.auto_drain:
            self.drain()
        return out

    # -- replication ---------------------------------------------------------
    def drain(self, region: Optional[str] = None) -> dict:
        """One drain pass of EVERY publisher (active homes + retired
        failover leftovers) toward all replicas, or just toward ``region``.
        Retired publishers drop off the moment their residual suffix is
        fully acked.  Returns per-publisher drain stats keyed by home
        (retired ones under ``retired:<dead-region>``)."""
        out: dict = {}
        for h, rep in list(self.replicators.items()):
            if region is None:
                out[h] = rep.drain()
            elif region in rep.delivery:
                out[h] = rep.drain(region)
        for entry in list(self.retired):
            rep = entry["rep"]
            if region is None:
                out[f"retired:{entry['label']}"] = rep.drain()
            elif region in rep.delivery:
                out[f"retired:{entry['label']}"] = rep.drain(region)
            if all(
                rep.log.pending_count(r) == 0 for r in rep.replica_regions()
            ):
                self.retired.remove(entry)
        self._refresh_lag_gauges()
        return out

    def pending_batches(self) -> int:
        """Total un-acked batches across every publisher — 0 means the mesh
        is fully converged (the chaos suite's drain-to-dry condition)."""
        return sum(
            rep.log.pending_count(r)
            for rep in self._all_replicators()
            for r in rep.replica_regions()
        )

    def converge(self, max_rounds: int = 64) -> int:
        """Drain until nothing is pending anywhere; returns the number of
        passes taken.  Raises ``DeliveryError`` if the mesh won't settle
        (a dead link that was never failed over)."""
        for i in range(max_rounds):
            if self.pending_batches() == 0:
                return i
            self.drain()
        raise DeliveryError(
            f"multi-home mesh did not converge within {max_rounds} drains"
        )

    def lag(self, region: str) -> LagStats:
        """How far ``region`` trails the REST OF THE MESH: the sum of every
        other publisher's un-acked backlog toward it (``LagStats.__add__``;
        staleness is the max across publishers).  Zero only when the
        region holds every other home's slices."""
        total = LagStats()
        for rep in self._all_replicators():
            if region != rep.home_region and region in rep.delivery:
                total = total + rep.lag(region)
        return total

    def _refresh_lag_gauges(self) -> None:
        for r in self.replicators:
            self.monitor.record_replication_lag(r, self.lag(r))
        # per-shard breakdown: a shard's lag gauge is its home-log backlog
        # toward the replica (exact when each home owns one range — the
        # bench topology; shared across a home's ranges otherwise)
        for h, rep in self.replicators.items():
            for sid in self.shard_map.owned_shards(h):
                for r in rep.replica_regions():
                    if r not in self.replicators:
                        continue
                    raw = rep.log.lag(r)
                    self.monitor.record_shard_lag(
                        r, sid, batches=raw.batches, rows=raw.rows
                    )

    # -- reads (per-range in-sync routing) -----------------------------------
    def route_shard_read(
        self,
        consumer_region: str,
        shard: int,
        *,
        max_lag_batches: Optional[int] = None,
    ) -> tuple[str, float]:
        """Serving region for one shard's key range: the consumer's own
        cell when it is healthy and in sync with the range's HOME log,
        else the nearest such region (the home itself is always in
        sync).  Returns (region, modeled one-way latency ms)."""
        max_lag = (
            self.max_lag_batches if max_lag_batches is None else max_lag_batches
        )
        home = self.shard_map.owner_of(shard)
        rep = self.replicators[home]
        candidates = [
            r
            for r in self.replicators
            if self.topology.regions[r].healthy
            and (
                r == home
                or (r in rep.delivery and rep.lag_batches(r) <= max_lag)
            )
        ]
        if not candidates:
            raise RegionDownError(
                f"no healthy in-sync replica of shard {shard} (home {home})"
            )
        if consumer_region in candidates:
            serving = consumer_region
        else:
            serving = min(
                candidates,
                key=lambda r: (self.topology.latency(consumer_region, r), r),
            )
        return serving, self.topology.latency(consumer_region, serving)

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
        """Cross-shard online GET: ids split by owning range, each range
        routed independently (``route_shard_read``), results scattered
        back in request order.  ``route`` records the per-range serving
        choice; ``modeled_ms`` is the max over ranges — the legs fan out
        concurrently, so the slowest range bounds the GET."""
        spec = self._specs[(name, version)]
        consumer = consumer_region or next(iter(self.replicators))
        ids = encode_keys(list(id_columns))
        n = len(ids)
        vals = np.zeros((n, len(spec.features)), np.float32)
        found = np.zeros(n, bool)
        route: dict = {"consumer": consumer, "per_range": {}, "modeled_ms": 0.0}
        now = self.clock()
        shards = self.shard_map.shard_of(ids)
        for sid in np.unique(shards):
            serving, ms = self.route_shard_read(
                consumer, int(sid), max_lag_batches=max_lag_batches
            )
            idx = np.flatnonzero(shards == sid)
            v, f, _ = self.online[serving].lookup_encoded(
                name, version, ids[idx], now=now, use_kernel=use_kernel
            )
            vals[idx] = v
            found[idx] = f
            route["per_range"][int(sid)] = {"region": serving, "modeled_ms": ms}
            route["modeled_ms"] = max(route["modeled_ms"], ms)
        self.monitor.system.observe("geo/read_modeled_ms", route["modeled_ms"])
        return vals, found, route

    # -- failure handling ----------------------------------------------------
    def mark_down(self, region: str) -> None:
        self.topology.mark_down(region)

    def mark_up(self, region: str) -> None:
        self.topology.mark_up(region)

    def failover(self, region: Optional[str] = None) -> Optional[dict]:
        """PER-SHARD failover: promote ONLY the lost region's ranges to the
        nearest in-sync replica of its log (``GeoReplicator.promote``
        replays the un-acked suffix there first, so nothing acked to the
        dead home is lost), reassign those ranges in the ShardMap, and
        drop the dead cell from every surviving publisher.  Every other
        home keeps its ranges — the blast radius is one region's slice of
        the keyspace, not the whole store.

        The promoted replicator's publish listeners are DETACHED: once the
        ShardMap reassigns the ranges, the new owner's OWN replicator
        publishes for them — leaving the promoted listeners attached would
        double-publish every new write at the promoted home.  The old log
        is retired, kept only until its residual suffix (batches the dead
        home had published but not every replica had acked) drains dry.

        ``region`` defaults to the first unhealthy active home; returns
        None when nothing is down."""
        if region is None:
            region = next(
                (
                    r
                    for r in self.replicators
                    if not self.topology.regions[r].healthy
                ),
                None,
            )
            if region is None:
                return None
        if region not in self.replicators:
            raise ValueError(f"region {region!r} is not an active home")
        if self.topology.regions[region].healthy:
            return None
        rep = self.replicators.pop(region)
        lost = self.shard_map.owned_shards(region)
        promoted = None
        replay = {"replayed_batches": 0, "replayed_rows": 0}
        if lost:
            healthy = [
                r
                for r in rep.replica_regions()
                if r in self.replicators and self.topology.regions[r].healthy
            ]
            if not healthy:
                raise RegionDownError(
                    f"no healthy replica to take {region}'s ranges"
                )
            in_sync = [
                r for r in healthy if rep.lag_batches(r) <= self.max_lag_batches
            ]
            pool = in_sync or healthy
            promoted = min(
                pool, key=lambda r: (self.topology.latency(region, r), r)
            )
            replay = rep.promote(promoted)
            self.online[promoted].merge_listeners.remove(rep._on_home_merge)
            self.offline[promoted].merge_listeners.remove(
                rep._on_home_offline_merge
            )
            for sid in lost:
                self.shard_map.assign(sid, promoted)
        for other in self.replicators.values():
            if region in other.delivery:
                other.evict_replica(region)
        for entry in self.retired:
            if region in entry["rep"].delivery:
                entry["rep"].evict_replica(region)
        if lost and any(
            rep.log.pending_count(r) for r in rep.replica_regions()
        ):
            self.retired.append({"label": region, "rep": rep})
        self.online.pop(region, None)
        self.offline.pop(region, None)
        self.monitor.clear_replica_gauges(region)
        self.monitor.record_shard_ownership(self.shard_map.owners)
        return {"promoted": promoted, "shards": lost, **replay}

    # -- membership (join/leave/rebalance) -----------------------------------
    def rejoin(self, region: str, *, chunk_rows: int = 65_536) -> dict:
        """Re-admit a recovered region: fresh two-plane cell, then each
        active home streams its OWNED ranges over the delta-bootstrap path
        (snapshot cut + catch-up from the registered cursor) — the union
        of owned ranges covers the whole keyspace, so the cell comes back
        complete, each range from its authoritative home.  The region
        returns with ZERO owned ranges (its old ones were promoted away);
        ``rebalance`` hands ranges back explicitly."""
        if region not in self.topology.regions:
            raise ValueError(f"unknown region {region}")
        if not self.topology.regions[region].healthy:
            raise RegionDownError(f"region {region} is still down; mark_up first")
        if region in self.replicators:
            raise ValueError(f"region {region} is already in the serving set")
        return {"rejoined": region, **self._admit(region, chunk_rows=chunk_rows)}

    def join_region(
        self,
        region: str,
        *,
        take_shards: Sequence[int] = (),
        chunk_rows: int = 65_536,
    ) -> dict:
        """Admit a brand-new region and optionally hand it ranges: admit
        (full per-home owned-range bootstrap), then ``rebalance`` each of
        ``take_shards`` onto it."""
        self.topology.regions.setdefault(region, Region(region))
        if region in self.replicators:
            raise ValueError(f"region {region} is already in the serving set")
        stats = self._admit(region, chunk_rows=chunk_rows)
        moves = [
            self.rebalance(int(sid), region, chunk_rows=chunk_rows)
            for sid in take_shards
        ]
        return {"joined": region, "moves": moves, **stats}

    def leave_region(self, region: str, *, chunk_rows: int = 65_536) -> dict:
        """Graceful leave: hand each owned range to the nearest surviving
        home (full ``rebalance`` per range — drain dry, stream, cut over),
        then retire the cell from every publisher."""
        if region not in self.replicators:
            raise ValueError(f"region {region!r} is not an active home")
        if len(self.replicators) < 3:
            raise ValueError("leaving would drop the mesh below two homes")
        moves = []
        for sid in list(self.shard_map.owned_shards(region)):
            dst = min(
                (r for r in self.replicators if r != region),
                key=lambda r: (self.topology.latency(region, r), r),
            )
            moves.append(self.rebalance(sid, dst, chunk_rows=chunk_rows))
        rep = self.replicators.pop(region)
        for _ in range(rep.policy.promote_rounds):
            if all(
                rep.log.pending_count(r) == 0 for r in rep.replica_regions()
            ):
                break
            rep.drain(force=True)
        else:
            raise DeliveryError(f"{region}'s log would not drain dry on leave")
        for other in self.replicators.values():
            if region in other.delivery:
                other.evict_replica(region)
        for entry in self.retired:
            if region in entry["rep"].delivery:
                entry["rep"].evict_replica(region)
        self.online.pop(region)
        self.offline.pop(region)
        self.monitor.clear_replica_gauges(region)
        self.monitor.record_shard_ownership(self.shard_map.owners)
        return {"left": region, "moves": moves}

    def rebalance(
        self, shard: int, to_region: str, *, chunk_rows: int = 65_536
    ) -> dict:
        """Move ONE range to a new home in three steps: (1) drain the
        current owner's log DRY, so every batch published under the old
        ownership lands everywhere before the cutover (an in-flight batch
        applied at the new owner AFTER it takes ownership would re-publish
        — a bounded echo the drain avoids entirely); (2) stream the moving
        range over ``bootstrap_delta(key_range=...)`` — idempotent top-up,
        a long-standing replica already holds it from normal replication;
        (3) cut the ShardMap over.  New writes for the range route to
        ``to_region`` from the moment ``assign`` bumps the version."""
        frm = self.shard_map.owner_of(shard)
        if to_region == frm:
            return {"shard": shard, "from": frm, "to": to_region, "moved": False}
        if to_region not in self.replicators:
            raise ValueError(
                f"{to_region!r} is not an active home; join_region first"
            )
        src = self.replicators[frm]
        for _ in range(src.policy.promote_rounds):
            if all(
                src.log.pending_count(r) == 0 for r in src.replica_regions()
            ):
                break
            src.drain(force=True)
        else:
            raise DeliveryError(
                f"shard {shard} rebalance: {frm}'s log would not drain dry"
            )
        lo, hi = self.shard_map.shard_range(shard)
        streamed = {"online_rows": 0, "offline_rows": 0, "chunks": 0}
        for spec in self._specs.values():
            got = src.bootstrap_delta(
                to_region, spec, chunk_rows=chunk_rows, key_range=(lo, hi)
            )
            for k in streamed:
                streamed[k] += got[k]
        self.shard_map.assign(shard, to_region)
        self.monitor.system.inc("shards/rebalances")
        self.monitor.record_shard_ownership(self.shard_map.owners)
        return {
            "shard": shard,
            "from": frm,
            "to": to_region,
            "moved": True,
            **streamed,
        }

    def _admit(self, region: str, *, chunk_rows: int) -> dict:
        """Shared join/rejoin data path: fresh cell, replica-of-everyone
        (each home streams its owned ranges), publisher-of-nothing (a
        fresh replicator with an empty log and no owned shards — its
        listeners' shard filter publishes nothing until ``rebalance``
        assigns it a range)."""
        online, offline = self._new_stores()
        for spec in self._specs.values():
            if spec.materialization.online_enabled:
                online.register(spec)
            if spec.materialization.offline_enabled:
                offline.register(spec)
        self.online[region] = online
        self.offline[region] = offline
        totals = {"online_rows": 0, "offline_rows": 0, "chunks": 0}
        for h, rep in self.replicators.items():
            rep.add_replica(region, online, offline)
            for sid in self.shard_map.owned_shards(h):
                key_range = self.shard_map.shard_range(sid)
                for spec in self._specs.values():
                    got = rep.bootstrap_delta(
                        region, spec, chunk_rows=chunk_rows, key_range=key_range
                    )
                    for k in totals:
                        totals[k] += got[k]
        peers = list(self.replicators)
        self._new_cell_replicator(region)
        for r in peers:
            self.replicators[region].add_replica(
                r, self.online[r], self.offline[r]
            )
        self.monitor.record_shard_ownership(self.shard_map.owners)
        return totals

    def _new_cell_replicator(self, region: str) -> None:
        self.replicators[region] = GeoReplicator(
            self.online[region],
            topology=self.topology,
            home_region=region,
            home_offline=self.offline[region],
            log=ReplicationLog(capacity=self._log_capacity),
            clock=self.clock,
            monitor=self.monitor,
            compress_level=self._compress_level,
            channel=self._channel,
            policy=self._policy,
            shard_map=self.shard_map,
        )
