"""Health/monitoring subsystem (paper §3.1.2, §2.1 SLAs).

Built-in (system) metrics plus custom (user-defined) metrics, and the
paper's headline SLA metric: DATA STALENESS/FRESHNESS — how fresh the
feature data computed by the platform is.

Latency distributions are tracked by ``BoundedHistogram``: geometric
buckets of fixed relative width, so the serving front can observe every
request's stage latencies forever (p50/p99/p999) in O(1) memory instead of
accumulating one float per sample.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Callable, Optional

import numpy as np

__all__ = ["BoundedHistogram", "Metrics", "HealthMonitor"]


class BoundedHistogram:
    """Quantile sketch in O(1) memory: geometric buckets of relative width
    ``resolution`` spanning [lo, hi); values clamp into the edge buckets.

    A reported quantile is the geometric midpoint of the bucket holding the
    rank (clamped to the observed min/max), so it lands within ~resolution
    of the exact sample quantile — unit-tested against numpy on known
    distributions — while storage stays one fixed int64 bucket array
    (~500 entries at the defaults) no matter how many samples arrive.
    Default bounds cover 10 ns .. 1000 s in microsecond units, i.e. any
    latency this system can observe."""

    __slots__ = ("lo", "growth", "counts", "n", "total", "vmin", "vmax")

    def __init__(
        self, lo: float = 1e-2, hi: float = 1e9, resolution: float = 0.05
    ) -> None:
        self.lo = float(lo)
        self.growth = math.log1p(resolution)
        nbuckets = int(math.ceil(math.log(hi / lo) / self.growth)) + 1
        self.counts = np.zeros(nbuckets, np.int64)
        self.n = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def _index(self, v: float) -> int:
        if v <= self.lo:
            return 0
        i = 1 + int(math.log(v / self.lo) / self.growth)
        return min(i, len(self.counts) - 1)

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[self._index(v)] += 1
        self.n += 1
        self.total += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    def observe_batch(self, values) -> None:
        """Vectorized ``observe`` — one bincount instead of a Python loop
        (the serving front records per-ticket queue waits this way)."""
        values = np.asarray(values, np.float64)
        if values.size == 0:
            return
        idx = np.zeros(values.shape, np.int64)
        above = values > self.lo
        idx[above] = 1 + (np.log(values[above] / self.lo) / self.growth).astype(
            np.int64
        )
        np.clip(idx, 0, len(self.counts) - 1, out=idx)
        self.counts += np.bincount(idx, minlength=len(self.counts))
        self.n += values.size
        self.total += float(values.sum())
        self.vmin = min(self.vmin, float(values.min()))
        self.vmax = max(self.vmax, float(values.max()))

    def quantile(self, q: float) -> float:
        if self.n == 0:
            return float("nan")
        rank = min(max(int(math.ceil(q * self.n)), 1), self.n)
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, rank))
        # geometric midpoint of bucket i, clamped to the observed range; the
        # underflow bucket (everything <= lo) reports the observed min
        mid = self.lo * math.exp((i - 0.5) * self.growth) if i else self.vmin
        return min(max(mid, self.vmin), self.vmax)

    def percentile(self, p: float) -> float:
        return self.quantile(p / 100.0)

    @property
    def mean(self) -> float:
        return self.total / self.n if self.n else float("nan")


class Metrics:
    def __init__(self) -> None:
        self.counters: dict[str, float] = defaultdict(float)
        self.gauges: dict[str, float] = {}
        self.histograms: dict[str, BoundedHistogram] = defaultdict(BoundedHistogram)

    def inc(self, name: str, by: float = 1.0) -> None:
        self.counters[name] += by

    def set_gauge(self, name: str, value: float) -> None:
        self.gauges[name] = value

    def observe(self, name: str, value: float) -> None:
        self.histograms[name].observe(value)

    def observe_batch(self, name: str, values) -> None:
        self.histograms[name].observe_batch(values)

    def snapshot(self) -> dict:
        return {
            "counters": dict(self.counters),
            "gauges": dict(self.gauges),
            "histograms": {
                k: {
                    "p50": h.percentile(50),
                    "p99": h.percentile(99),
                    "p999": h.percentile(99.9),
                    "max": h.vmax,
                    "n": h.n,
                }
                for k, h in self.histograms.items()
            },
        }


class HealthMonitor:
    """System + custom metrics, alerting, and staleness tracking."""

    def __init__(self, alert_hook: Optional[Callable[[str], None]] = None):
        self.system = Metrics()
        self.custom = Metrics()
        self.alerts: list[str] = []
        self._alert_hook = alert_hook

    def alert(self, message: str) -> None:
        self.alerts.append(message)
        if self._alert_hook:
            self._alert_hook(message)

    # -- built-in signal helpers ------------------------------------------------
    def record_job(self, success: bool, retried: bool = False) -> None:
        self.system.inc("jobs_succeeded" if success else "jobs_failed")
        if retried:
            self.system.inc("jobs_retried")

    def record_staleness(
        self, feature_set: str, version: int, ms: Optional[int]
    ) -> None:
        if ms is not None:
            self.system.set_gauge(f"staleness_ms/{feature_set}:v{version}", float(ms))

    def record_lookup_latency(self, us: float) -> None:
        self.system.observe("online_lookup_us", us)

    def record_serving_stage(self, stage: str, us: float) -> None:
        """One serving-front pipeline stage (queue_wait / assembly / kernel /
        decode / request) for one dispatch — p50/p99/p999 per stage ride the
        bounded histograms, so the front can observe every request."""
        self.system.observe(f"serving/{stage}_us", us)

    def record_serving_stale_age(self, ms: float) -> None:
        """Age (logical ms since the cached row was superseded) of one
        degraded bounded-staleness serve — the serving front's overload
        escape hatch; the configured bound is asserted over this
        histogram's max."""
        self.system.observe("serving/stale_age_ms", ms)

    def record_replication_lag(self, replica: str, lag) -> None:
        """Per-replica geo-replication lag (§4.1.2 road-map mechanism): how
        many un-acked merge batches/rows the replica is behind, and how old
        the oldest pending batch is in clock units.  ``lag`` is a
        ``replication.LagStats`` (duck-typed here so monitoring stays
        import-free of the data plane); the per-plane breakdown (online
        serving vs offline history) gets its own gauges, so an offline-only
        backlog is visible rather than averaged away."""
        self.system.set_gauge(f"replication/lag_batches/{replica}", float(lag.batches))
        self.system.set_gauge(f"replication/lag_rows/{replica}", float(lag.rows))
        self.system.set_gauge(
            f"replication/staleness_ms/{replica}", float(lag.staleness_ms)
        )
        for plane, d in lag.planes.items():
            self.system.set_gauge(
                f"replication/lag_batches/{plane}/{replica}", float(d.batches)
            )
            self.system.set_gauge(
                f"replication/lag_rows/{plane}/{replica}", float(d.rows)
            )

    def record_shard_lag(
        self, replica: str, shard: int, *, batches: int, rows: int
    ) -> None:
        """Un-acked backlog of ONE shard-home's log toward one replica —
        the multi-home breakdown of ``record_replication_lag``.  The
        replica name sits MID-PATH (the shard id is the trailing segment),
        which is exactly the shape the old suffix-only
        ``clear_replica_gauges`` missed."""
        self.system.set_gauge(
            f"replication/shard_lag_batches/{replica}/{shard}", float(batches)
        )
        self.system.set_gauge(
            f"replication/shard_lag_rows/{replica}/{shard}", float(rows)
        )

    def record_shard_ownership(self, owners) -> None:
        """Current ShardMap assignment: per-shard owner index plus per-region
        owned-range counts, refreshed wholesale after any cutover."""
        regions = sorted(set(owners))
        for sid, region in enumerate(owners):
            self.system.set_gauge(
                f"shards/owner_index/{sid}", float(regions.index(region))
            )
        for region in regions:
            self.system.set_gauge(
                f"shards/owned/{region}",
                float(sum(1 for o in owners if o == region)),
            )

    def record_forwarded_write(self, src: str, dst: str, rows: int) -> None:
        """Rows a multi-home write split out of ``src``'s batch and routed
        to shard-home ``dst`` — the cross-region write-forwarding cost the
        multi-home bench gates as a fraction of total written rows."""
        self.system.inc("multihome/forwarded_rows", rows)
        self.system.inc(f"multihome/forwarded_rows/{src}/{dst}", rows)

    def record_replication_ship(
        self,
        rows: int,
        *,
        raw_nbytes: int,
        wire_nbytes: int,
        batches: int = 1,
        plane: Optional[str] = None,
    ) -> None:
        """One wire frame shipped to a replica.  Both byte counters are
        MEASURED off the encoded frame (core/wire.py), not estimated from
        array sizes: ``shipped_bytes`` is the post-compression wire size
        that actually crosses the WAN, ``shipped_raw_bytes`` the serialized
        payload before compression.  A coalesced frame carries several
        batches, so ``batches`` rides along explicitly."""
        self.system.inc("replication/shipped_frames")
        self.system.inc("replication/shipped_batches", batches)
        self.system.inc("replication/shipped_rows", rows)
        self.system.inc("replication/shipped_bytes", wire_nbytes)
        self.system.inc("replication/shipped_raw_bytes", raw_nbytes)
        if plane is not None:
            self.system.inc(f"replication/shipped_frames/{plane}")
            self.system.inc(f"replication/shipped_batches/{plane}", batches)
            self.system.inc(f"replication/shipped_rows/{plane}", rows)
            self.system.inc(f"replication/shipped_bytes/{plane}", wire_nbytes)
            self.system.inc(f"replication/shipped_raw_bytes/{plane}", raw_nbytes)

    def record_delivery_state(self, replica: str, state: str, code: int) -> None:
        """The delivery state machine's verdict on one replica link:
        HEALTHY(0) / SUSPECT(1) / DEAD(2).  The gauge is the current state
        code; the counter tallies transitions so a flapping link is visible
        even when the gauge reads healthy at scrape time."""
        self.system.set_gauge(f"replication/state/{replica}", float(code))
        self.system.inc(f"replication/state_transitions/{replica}")

    def record_delivery_retry(self, replica: str, batches: int) -> None:
        """Batches re-shipped to a replica after an earlier transmit went
        un-acked (timeout, drop, corruption) — the at-least-once transport's
        redundancy cost, a.k.a. retry amplification."""
        self.system.inc("replication/retries", batches)
        self.system.inc(f"replication/retries/{replica}", batches)

    def record_delivery_fault(self, replica: str, kind: str, n: int = 1) -> None:
        """One detected delivery fault on a replica link: ``timeout`` (no
        ack back in time), ``corrupt_frame`` (wire CRC rejected an arrival),
        or ``redelivered`` (an already-acked batch arrived again and was
        absorbed by per-seq dedup)."""
        self.system.inc(f"replication/{kind}", n)
        self.system.inc(f"replication/{kind}/{replica}", n)

    def clear_replica_gauges(self, replica: str) -> None:
        """Drop every per-replica replication gauge when the replica leaves
        the serving set (drop, failover promotion, dead ex-home).  Gauges
        are last-value-wins: without this, a departed region keeps
        reporting its final lag/staleness forever, which reads as a live
        replica that stopped draining.

        The match is on the replica as a FULL path segment ANYWHERE in the
        key, not just the suffix: per-shard gauges
        (``replication/shard_lag_batches/{replica}/{shard}``) put the
        replica mid-path, and the old suffix-only match left those behind —
        a rejoined region resurrected its pre-eviction per-shard lag
        readings."""
        gauges = self.system.gauges
        for key in [
            k
            for k in gauges
            if k.startswith("replication/") and replica in k.split("/")
        ]:
            del gauges[key]

    def healthy(self) -> bool:
        failed = self.system.counters.get("jobs_failed", 0)
        ok = self.system.counters.get("jobs_succeeded", 0)
        return failed == 0 or ok / max(ok + failed, 1) > 0.95
