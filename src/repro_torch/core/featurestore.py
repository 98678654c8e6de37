"""The managed feature store facade (paper §2.1 functional surface).

Wires every subsystem together behind the operations the paper lists:
feature store management, asset management, feature engineering (scheduled +
backfill materialization, online retrieval), monitoring/lineage, and
geo-distributed placement.

Not ported yet: offline point-in-time retrieval (``get_offline_features``)
and the replication surface (``lag``, ``drain``, ``failover``, ``rejoin``,
``attach_replication``).
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch.core.assets import Entity, FeatureSetSpec
from repro_torch.core.consistency import (
    bootstrap_offline_to_online,
    bootstrap_online_to_offline,
    check_consistency,
)
from repro_torch.core.lineage import LineageGraph, ModelNode
from repro_torch.core.materializer import FaultInjector, Materializer
from repro_torch.core.monitoring import HealthMonitor
from repro_torch.core.offline_store import OfflineStore
from repro_torch.core.online_store import OnlineStore
from repro_torch.core.registry import AssetRegistry
from repro_torch.core.regions import (
    GeoPlacement,
    GeoTopology,
    Region,
    ReplicationPolicy,
)
from repro_torch.core.scheduler import Scheduler
from repro_torch.core.serving import ServingConfig, ServingFront
from repro_torch.core.table import Table
from repro_torch.core.transform import FeatureWindow, SourceProtocol

__all__ = ["FeatureStore"]


class FeatureStore:
    def __init__(
        self,
        name: str,
        *,
        region: str = "region-0",
        subscription: str = "sub-0",
        topology: Optional[GeoTopology] = None,
        replication: ReplicationPolicy = ReplicationPolicy.CROSS_REGION_ACCESS,
        clock: Optional[Callable[[], int]] = None,
        offline_shards: int = 4,
        online_partitions: int = 16,
        device: str | torch.device = "cuda",
        merge_engine: str = "vector",
        serving: Optional[ServingConfig] = None,
    ) -> None:
        self.name = name
        self._now = 0
        self.clock = clock or (lambda: self._now)
        self.registry = AssetRegistry(name, region, subscription)
        self.offline = OfflineStore(
            num_shards=offline_shards, merge_engine=merge_engine
        )
        self.online = OnlineStore(
            num_partitions=online_partitions,
            device=device,
            merge_engine=merge_engine,
        )
        self.scheduler = Scheduler()
        self.monitor = HealthMonitor()
        self.lineage = LineageGraph()
        self.faults = FaultInjector()
        self.materializer = Materializer(
            self.offline, self.online, clock=self.clock, faults=self.faults
        )
        if topology is None:
            topology = GeoTopology(regions={region: Region(region)})
        self.geo = GeoPlacement(topology, region, replication)
        # every online GET goes through the serving front (core/serving.py).
        # The default config is a pure passthrough (no cache, no admission
        # control) so a plain store keeps exact OnlineStore.lookup semantics;
        # pass a ServingConfig to turn on micro-batching/caching/shedding.
        self.serving = ServingFront(
            lambda: self.online,
            config=serving or ServingConfig(),
            clock=self.clock,
            monitor=self.monitor,
        )
        self._sources: dict[str, SourceProtocol] = {}
        self.device = self.online.device

        from repro_torch.runtime.supervisor import Supervisor  # avoid cycle

        self.supervisor = Supervisor(
            self.scheduler,
            self.materializer,
            self.monitor,
            spec_resolver=self.registry.get_feature_set,
            source_resolver=lambda n: self._sources[n],
        )

    # -- clock (tests drive time explicitly) ---------------------------------
    def advance_clock(self, to: int) -> None:
        self._now = max(self._now, to)

    # -- asset management ------------------------------------------------------
    def register_source(self, source: SourceProtocol) -> None:
        self._sources[source.name] = source

    def create_entity(self, entity: Entity) -> Entity:
        return self.registry.create_entity(entity)

    def create_feature_set(self, spec: FeatureSetSpec) -> FeatureSetSpec:
        spec = self.registry.create_feature_set(spec)
        if spec.source_name not in self._sources:
            raise ValueError(f"register source {spec.source_name!r} first")
        self.offline.register(spec)
        if spec.materialization.online_enabled:
            self.online.register(spec)
        self.scheduler.register_feature_set(
            spec.name,
            spec.version,
            schedule_interval=spec.materialization.schedule_interval,
            partition_window=spec.materialization.partition_window,
        )
        return spec

    # -- feature engineering -----------------------------------------------------
    def tick(self, now: Optional[int] = None) -> dict[str, int]:
        """Advance the schedule clock: generate due incremental jobs and drain
        the queue (recurrent materialization, §2.1)."""
        if now is not None:
            self.advance_clock(now)
        self.scheduler.tick(self.clock())
        stats = self.supervisor.drain()
        self._refresh_staleness()
        return stats

    def backfill(self, name: str, version: int, start: int, end: int) -> dict[str, int]:
        """On-demand backfill materialization (§2.1, §4.3)."""
        self.scheduler.request_backfill(name, version, FeatureWindow(start, end))
        stats = self.supervisor.drain()
        self.scheduler.resume_suspended()
        stats2 = self.supervisor.drain()
        self._refresh_staleness()
        return {k: stats[k] + stats2[k] for k in stats}

    def repair(self, name: str, version: int) -> dict[str, int]:
        """Re-enqueue every unmaterialized gap behind the schedule cursor as
        backfill jobs — the §4.5.2 'manual retry' that guarantees eventual
        consistency even after jobs exhaust their automatic retry budget.
        Fresh jobs get a fresh retry budget; merge idempotence makes any
        overlap with earlier partial progress safe."""
        cursor = self.scheduler.schedule_cursor.get((name, version), 0)
        if cursor <= 0:
            return {"succeeded": 0, "retried": 0, "failed": 0}
        self.scheduler.request_backfill(name, version, FeatureWindow(0, cursor))
        stats = self.supervisor.drain()
        self.scheduler.resume_suspended()
        stats2 = self.supervisor.drain()
        self._refresh_staleness()
        return {k: stats[k] + stats2[k] for k in stats}

    def write_batch(
        self,
        name: str,
        version: int,
        frame: Table,
        *,
        creation_ts: Optional[int] = None,
        region: Optional[str] = None,
    ) -> dict:
        """Direct ingest of one frame outside the scheduler — the
        ``StoreFacade`` write surface.  Merges into every enabled plane
        with one shared creation_ts (offline first, like a materialization
        job).  ``region`` is accepted for facade parity and ignored: a
        single-region store has exactly one place the write can land."""
        spec = self.registry.get_feature_set(name, version)
        creation = int(self.clock()) if creation_ts is None else int(creation_ts)
        out: dict = {"rows": len(frame), "creation_ts": creation}
        if spec.materialization.offline_enabled:
            out["offline"] = self.offline.merge_with_stats(spec, frame, creation)
        if spec.materialization.online_enabled:
            out["online"] = self.online.merge(spec, frame, creation)
        return out

    def get_online_features(
        self,
        name: str,
        version: int,
        id_columns: list[np.ndarray],
        *,
        use_kernel: bool = True,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Low-latency online retrieval (§2.1 item 4), routed through the
        serving front: this GET joins any tickets already queued for the
        table, so concurrent callers share one coalesced store dispatch."""
        import time as _time

        t0 = _time.perf_counter()
        out = self.serving.get(
            name,
            version,
            id_columns,
            now=self.clock(),
            engine="kernel" if use_kernel else "host",
        )
        self.monitor.record_lookup_latency((_time.perf_counter() - t0) * 1e6)
        return out

    # -- consistency & bootstrap ----------------------------------------------------
    def check_consistency(self, name: str, version: int):
        spec = self.registry.get_feature_set(name, version)
        return check_consistency(spec, self.offline, self.online)

    def enable_online(self, name: str, version: int) -> int:
        """Late-enable the online store and bootstrap it from offline (§4.5.5)."""
        spec = self.registry.get_feature_set(name, version)
        spec.materialization.online_enabled = True
        self.online.register(spec)
        return bootstrap_offline_to_online(
            spec, self.offline, self.online, self.clock()
        )

    def enable_offline(self, name: str, version: int) -> int:
        """Late-enable the offline store and bootstrap it from online (§4.5.5)."""
        spec = self.registry.get_feature_set(name, version)
        spec.materialization.offline_enabled = True
        self.offline.register(spec)
        return bootstrap_online_to_offline(spec, self.offline, self.online)

    # -- lineage -----------------------------------------------------------------
    def track_model(
        self, model: ModelNode, feature_sets: Sequence[tuple[str, int]]
    ) -> None:
        refs = []
        for n, v in feature_sets:
            spec = self.registry.get_feature_set(n, v)
            refs.extend(spec.full_feature_names())
        self.lineage.register_model(model, refs)

    # -- internals ------------------------------------------------------------------
    def _refresh_staleness(self) -> None:
        now = self.clock()
        for name, version in self.registry.list_feature_sets():
            ms = self.scheduler.staleness(name, version, now)
            self.monitor.record_staleness(name, version, ms)
        # surface the online store's host<->device traffic ledger so a
        # transfer regression on the serving path shows up in monitoring
        for k, v in self.online.transfer_stats().items():
            self.monitor.system.set_gauge(f"online_store/{k}", v)

    # -- state checkpoint (resume without data loss) ----------------------------------
    def scheduler_state(self) -> str:
        return self.scheduler.to_json()

    def restore_scheduler(self, payload: str) -> None:
        self.scheduler = Scheduler.from_json(payload)
        self.supervisor.scheduler = self.scheduler
