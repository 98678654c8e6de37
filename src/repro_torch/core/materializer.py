"""Materialization job execution (paper §4.3, §4.5.3–4.5.4).

A job covers one feature window: run Algorithm 1, then merge the resulting
frame into the offline and/or online store — the SAME frame into both, which
is what makes the two stores eventually consistent (§4.5.4).  Failures may
strike between the two merges; merge idempotence (offline full-key dedup,
online latest-wins) guarantees retries converge.

``FaultInjector`` lets tests and benchmarks break the pipeline at the exact
seams the paper discusses: after compute, after the offline merge, after the
online merge.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

from repro_torch.core.assets import FeatureSetSpec
from repro_torch.core.offline_store import OfflineStore
from repro_torch.core.online_store import OnlineStore
from repro_torch.core.scheduler import MaterializationJob
from repro_torch.core.transform import SourceProtocol, compute_feature_window

__all__ = ["FaultInjector", "Materializer", "MaterializationOutcome"]


class FaultInjector:
    """Deterministic failure injection at named seams.

    Two modes, composable: ``arm(seam, n)`` fails the next n passes through
    one seam (targeted tests); ``set_failure_rate(p, seed)`` makes every seam
    fail with probability p from a seeded stream (chaos benchmarks — still
    reproducible)."""

    def __init__(self) -> None:
        self._arm: dict[str, int] = {}
        self._rate = 0.0
        self._rng = None

    def arm(self, seam: str, times: int = 1) -> None:
        self._arm[seam] = self._arm.get(seam, 0) + times

    def set_failure_rate(self, p: float, *, seed: int = 0) -> None:
        import numpy as _np

        self._rate = float(p)
        self._rng = _np.random.default_rng(seed)

    def check(self, seam: str) -> None:
        if self._arm.get(seam, 0) > 0:
            self._arm[seam] -= 1
            raise RuntimeError(f"injected fault at seam {seam!r}")
        if self._rate and self._rng is not None and self._rng.random() < self._rate:
            raise RuntimeError(f"injected fault (p={self._rate}) at seam {seam!r}")


@dataclasses.dataclass
class MaterializationOutcome:
    job_id: int
    rows: int
    offline_merged: bool
    online_merged: bool
    creation_ts: int
    # per-batch Algorithm-2 stats from the online merge plan (tallies +
    # touched-slot count) — the reduced form geo-replication ships
    online_stats: Optional[dict] = None
    # per-batch offline merge tallies (insert/dedup counts + the assigned
    # replication seq) — the offline plane's half of the same shipping story
    offline_stats: Optional[dict] = None


class Materializer:
    def __init__(
        self,
        offline: OfflineStore,
        online: OnlineStore,
        *,
        clock: Callable[[], int],
        faults: Optional[FaultInjector] = None,
        merge_engine: Optional[str] = None,
    ) -> None:
        self.offline = offline
        self.online = online
        self.clock = clock
        self.faults = faults or FaultInjector()
        # None -> each store's own default; "loop"/"vector"/"kernel" forces
        # one write path end-to-end (benchmarks flip old-style vs engine here)
        self.merge_engine = merge_engine
        self.outcomes: list[MaterializationOutcome] = []

    def run_job(
        self,
        job: MaterializationJob,
        spec: FeatureSetSpec,
        source: SourceProtocol,
    ) -> MaterializationOutcome:
        """Execute one job; raises on (injected or real) failure.  The paper's
        merge order — offline first, then online — is fixed, which is one of
        the §4.5.4 reasons the stores are only EVENTUALLY consistent."""
        self.faults.check("before_compute")
        frame = compute_feature_window(spec, source, job.window)
        self.faults.check("after_compute")

        creation_ts = int(self.clock())
        offline_done = online_done = False
        offline_stats = None
        if spec.materialization.offline_enabled:
            # OfflineStore normalizes "kernel" (online-only) to its vector path
            stats = self.offline.merge_with_stats(
                spec, frame, creation_ts, engine=self.merge_engine
            )
            offline_stats = {
                "inserted": stats["inserted"],
                "deduped": stats["deduped"],
                # seq the geo-replication log assigned this batch's offline
                # plane (annotated by the GeoReplicator's offline merge
                # listener; None when unattached or fully deduped)
                "replication_seq": stats.get("replication_seq"),
            }
            offline_done = True
        self.faults.check("between_merges")
        online_stats = None
        if spec.materialization.online_enabled:
            stats = self.online.merge(
                spec, frame, creation_ts, engine=self.merge_engine
            )
            online_stats = {
                "inserts": stats["inserts"],
                "overrides": stats["overrides"],
                "noops": stats["noops"],
                "touched_slots": len(stats["touched_slots"]),
                # seq the geo-replication log assigned this batch (annotated
                # by the GeoReplicator's merge listener; None when no
                # replication is attached or the batch was all no-ops)
                "replication_seq": stats.get("replication_seq"),
            }
            online_done = True
        self.faults.check("after_merges")

        outcome = MaterializationOutcome(
            job.job_id,
            len(frame),
            offline_done,
            online_done,
            creation_ts,
            online_stats=online_stats,
            offline_stats=offline_stats,
        )
        self.outcomes.append(outcome)
        return outcome
