"""Materialization scheduling subsystem (paper §3.1.1, §4.3).

Tracks the two state machines the paper requires:

  * DATA STATE — per feature-set version, an interval set over the feature
    event timeline recording which windows are materialized.  Retrieval can
    therefore distinguish "window not materialized" from "window materialized
    but empty" (§4.3).
  * JOB STATE — queued/running/succeeded/failed jobs and the feature window
    each covers, with the invariant that CONCURRENT JOBS NEVER OVERLAP in
    feature window for the same feature-set version (§4.3: no
    nondeterministic store contents).

Context-aware scheduling (§3.1.1):
  * scheduled incremental jobs are generated on a cadence, each covering the
    next incremental window;
  * a backfill request SUSPENDS conflicting scheduled jobs (they resume —
    are regenerated — after the backfill window is covered);
  * backfill windows are partitioned into unit windows per the feature set's
    ``partition_window`` (customer-providable), skipping already-materialized
    sub-windows (coalescing).

Fault tolerance: job execution is delegated to runtime/supervisor with
retry/backoff; the whole scheduler state serializes to/from JSON so a
restarted runtime "safely resumes from where it left off without data loss"
(§3.1.2).
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Optional

from repro_torch.core.transform import FeatureWindow

__all__ = ["IntervalSet", "JobState", "JobKind", "MaterializationJob", "Scheduler"]


class IntervalSet:
    """Sorted, disjoint, half-open [start, end) intervals over the timeline."""

    def __init__(self, intervals: Optional[list[tuple[int, int]]] = None):
        self._iv: list[tuple[int, int]] = []
        for s, e in intervals or []:
            self.add(s, e)

    def add(self, start: int, end: int) -> None:
        if end <= start:
            raise ValueError("empty interval")
        merged = []
        placed = False
        for s, e in self._iv:
            if e < start or s > end:  # disjoint (touching intervals merge)
                merged.append((s, e))
            else:
                start, end = min(start, s), max(end, e)
        for i, (s, e) in enumerate(merged):
            if start < s:
                merged.insert(i, (start, end))
                placed = True
                break
        if not placed:
            merged.append((start, end))
        self._iv = merged

    def subtract(self, start: int, end: int) -> None:
        out = []
        for s, e in self._iv:
            if e <= start or s >= end:
                out.append((s, e))
                continue
            if s < start:
                out.append((s, start))
            if e > end:
                out.append((end, e))
        self._iv = out

    def covers(self, start: int, end: int) -> bool:
        for s, e in self._iv:
            if s <= start and end <= e:
                return True
        return False

    def overlaps(self, start: int, end: int) -> bool:
        return any(s < end and start < e for s, e in self._iv)

    def gaps_within(self, start: int, end: int) -> list[tuple[int, int]]:
        """Sub-windows of [start,end) NOT covered (the coalescing primitive)."""
        gaps = []
        cur = start
        for s, e in self._iv:
            if e <= cur or s >= end:
                continue
            if s > cur:
                gaps.append((cur, min(s, end)))
            cur = max(cur, e)
            if cur >= end:
                break
        if cur < end:
            gaps.append((cur, end))
        return gaps

    @property
    def intervals(self) -> list[tuple[int, int]]:
        return list(self._iv)

    def total_length(self) -> int:
        return sum(e - s for s, e in self._iv)

    def to_json(self) -> list[list[int]]:
        return [[s, e] for s, e in self._iv]

    @staticmethod
    def from_json(data: list[list[int]]) -> "IntervalSet":
        out = IntervalSet()
        out._iv = [(int(s), int(e)) for s, e in data]
        return out


class JobState(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    SUCCEEDED = "succeeded"
    FAILED = "failed"
    SUSPENDED = "suspended"
    CANCELLED = "cancelled"


class JobKind(enum.Enum):
    BACKFILL = "backfill"
    SCHEDULED = "scheduled"
    BOOTSTRAP = "bootstrap"


@dataclasses.dataclass
class MaterializationJob:
    job_id: int
    feature_set: str
    version: int
    window: FeatureWindow
    kind: JobKind
    state: JobState = JobState.QUEUED
    attempts: int = 0
    max_attempts: int = 3
    error: Optional[str] = None

    def to_json(self) -> dict:
        return {
            "job_id": self.job_id,
            "feature_set": self.feature_set,
            "version": self.version,
            "window": [self.window.start, self.window.end],
            "kind": self.kind.value,
            "state": self.state.value,
            "attempts": self.attempts,
            "max_attempts": self.max_attempts,
            "error": self.error,
        }

    @staticmethod
    def from_json(d: dict) -> "MaterializationJob":
        return MaterializationJob(
            job_id=d["job_id"],
            feature_set=d["feature_set"],
            version=d["version"],
            window=FeatureWindow(*d["window"]),
            kind=JobKind(d["kind"]),
            state=JobState(d["state"]),
            attempts=d["attempts"],
            max_attempts=d["max_attempts"],
            error=d.get("error"),
        )


class Scheduler:
    """Context-aware materialization scheduler for one feature store."""

    def __init__(self) -> None:
        self._next_job_id = 1
        self.jobs: dict[int, MaterializationJob] = {}
        # (name, version) -> materialized-data interval state
        self.data_state: dict[tuple[str, int], IntervalSet] = {}
        # (name, version) -> high-water mark of scheduled materialization
        self.schedule_cursor: dict[tuple[str, int], int] = {}
        # (name, version) -> cadence / unit window (from the spec)
        self._cadence: dict[tuple[str, int], int] = {}
        self._partition_window: dict[tuple[str, int], int] = {}
        self.alerts: list[str] = []

    # -- registration --------------------------------------------------------
    def register_feature_set(
        self,
        name: str,
        version: int,
        *,
        schedule_interval: Optional[int],
        partition_window: Optional[int],
        timeline_origin: int = 0,
    ) -> None:
        key = (name, version)
        self.data_state.setdefault(key, IntervalSet())
        if schedule_interval:
            self._cadence[key] = schedule_interval
            self.schedule_cursor.setdefault(key, timeline_origin)
        self._partition_window[key] = (
            partition_window or schedule_interval or 3_600_000
        )

    # -- invariants ------------------------------------------------------------
    def _active_jobs(self, key: tuple[str, int]) -> list[MaterializationJob]:
        return [
            j
            for j in self.jobs.values()
            if (j.feature_set, j.version) == key
            and j.state in (JobState.QUEUED, JobState.RUNNING)
        ]

    def _conflicts(self, key: tuple[str, int], window: FeatureWindow) -> list:
        return [j for j in self._active_jobs(key) if j.window.overlaps(window)]

    def _enqueue(
        self, key: tuple[str, int], window: FeatureWindow, kind: JobKind
    ) -> MaterializationJob:
        if self._conflicts(key, window):
            raise RuntimeError(
                f"scheduling invariant violated: overlapping active window "
                f"{window} for {key}"
            )
        job = MaterializationJob(self._next_job_id, key[0], key[1], window, kind)
        self._next_job_id += 1
        self.jobs[job.job_id] = job
        return job

    # -- scheduled incremental jobs (§4.3) --------------------------------------
    def tick(self, now: int) -> list[MaterializationJob]:
        """Generate scheduled incremental jobs up to ``now``.  Each job covers
        one cadence window [cursor, cursor + cadence)."""
        new_jobs = []
        for key, cadence in self._cadence.items():
            cursor = self.schedule_cursor[key]
            while cursor + cadence <= now:
                window = FeatureWindow(cursor, cursor + cadence)
                if self._conflicts(key, window):
                    # An active (likely backfill) job owns this span; stop
                    # generating until it completes (context-aware suspend).
                    break
                if self.data_state[key].covers(window.start, window.end):
                    cursor += cadence  # already materialized (by a backfill)
                    self.schedule_cursor[key] = cursor
                    continue
                new_jobs.append(self._enqueue(key, window, JobKind.SCHEDULED))
                cursor += cadence
                self.schedule_cursor[key] = cursor
        return new_jobs

    # -- backfill (§3.1.1, §4.3) --------------------------------------------------
    def request_backfill(
        self, name: str, version: int, window: FeatureWindow
    ) -> list[MaterializationJob]:
        """On-demand backfill: suspend conflicting queued scheduled jobs,
        partition the window into unit windows, skip covered sub-windows."""
        key = (name, version)
        suspended = 0
        for j in self._conflicts(key, window):
            if j.kind is JobKind.SCHEDULED and j.state is JobState.QUEUED:
                j.state = JobState.SUSPENDED
                suspended += 1
            else:
                raise RuntimeError(
                    f"backfill window {window} conflicts with running job "
                    f"{j.job_id}; retry after it completes"
                )
        unit = self._partition_window[key]
        jobs = []
        for gap_s, gap_e in self.data_state[key].gaps_within(window.start, window.end):
            cur = gap_s
            while cur < gap_e:
                jobs.append(
                    self._enqueue(
                        key,
                        FeatureWindow(cur, min(cur + unit, gap_e)),
                        JobKind.BACKFILL,
                    )
                )
                cur += unit
        return jobs

    def resume_suspended(self) -> list[MaterializationJob]:
        """Re-queue suspended scheduled jobs whose window is still needed."""
        resumed = []
        for j in self.jobs.values():
            if j.state is not JobState.SUSPENDED:
                continue
            key = (j.feature_set, j.version)
            if self.data_state[key].covers(j.window.start, j.window.end):
                j.state = JobState.CANCELLED  # backfill already covered it
            elif not self._conflicts(key, j.window):
                j.state = JobState.QUEUED
                resumed.append(j)
        return resumed

    # -- job lifecycle -------------------------------------------------------------
    def runnable_jobs(self) -> list[MaterializationJob]:
        return sorted(
            (j for j in self.jobs.values() if j.state is JobState.QUEUED),
            key=lambda j: (j.kind is not JobKind.BACKFILL, j.window.start),
        )

    def mark_running(self, job_id: int) -> None:
        self.jobs[job_id].state = JobState.RUNNING

    def mark_succeeded(self, job_id: int) -> None:
        j = self.jobs[job_id]
        j.state = JobState.SUCCEEDED
        self.data_state[(j.feature_set, j.version)].add(j.window.start, j.window.end)

    def mark_failed(self, job_id: int, error: str) -> bool:
        """Returns True if the job will be retried (back to QUEUED)."""
        j = self.jobs[job_id]
        j.attempts += 1
        j.error = error
        if j.attempts < j.max_attempts:
            j.state = JobState.QUEUED
            return True
        j.state = JobState.FAILED
        self.alerts.append(
            f"non-recoverable failure: job {job_id} ({j.feature_set}:"
            f"v{j.version} {j.window}) after {j.attempts} attempts: {error}"
        )
        return False

    # -- retrieval support (§4.3 disambiguation) ------------------------------------
    def materialized_intervals(self, name: str, version: int) -> list[tuple[int, int]]:
        """The §4.3 data-state view: which feature windows are materialized."""
        return self.data_state.get((name, version), IntervalSet()).intervals

    def is_materialized(self, name: str, version: int, start: int, end: int) -> bool:
        return self.data_state[(name, version)].covers(start, end)

    def staleness(self, name: str, version: int, now: int) -> Optional[int]:
        """Freshness metric (§2.1): ms between now and the newest materialized
        event time; None if nothing is materialized."""
        iv = self.data_state[(name, version)].intervals
        if not iv:
            return None
        return max(0, now - iv[-1][1])

    # -- persistence (resume without data loss, §3.1.2) -------------------------------
    def to_json(self) -> str:
        return json.dumps(
            {
                "next_job_id": self._next_job_id,
                "jobs": [j.to_json() for j in self.jobs.values()],
                "data_state": {
                    f"{k[0]}::{k[1]}": v.to_json()
                    for k, v in self.data_state.items()
                },
                "schedule_cursor": {
                    f"{k[0]}::{k[1]}": v for k, v in self.schedule_cursor.items()
                },
                "cadence": {
                    f"{k[0]}::{k[1]}": v for k, v in self._cadence.items()
                },
                "partition_window": {
                    f"{k[0]}::{k[1]}": v
                    for k, v in self._partition_window.items()
                },
                "alerts": self.alerts,
            }
        )

    @staticmethod
    def from_json(payload: str) -> "Scheduler":
        d = json.loads(payload)
        sched = Scheduler()
        sched._next_job_id = d["next_job_id"]
        for jd in d["jobs"]:
            job = MaterializationJob.from_json(jd)
            # A RUNNING job at checkpoint time was interrupted: requeue it.
            if job.state is JobState.RUNNING:
                job.state = JobState.QUEUED
            sched.jobs[job.job_id] = job

        def _k(s: str) -> tuple[str, int]:
            name, ver = s.rsplit("::", 1)
            return (name, int(ver))

        sched.data_state = {
            _k(k): IntervalSet.from_json(v) for k, v in d["data_state"].items()
        }
        sched.schedule_cursor = {
            _k(k): v for k, v in d["schedule_cursor"].items()
        }
        sched._cadence = {_k(k): v for k, v in d["cadence"].items()}
        sched._partition_window = {
            _k(k): v for k, v in d["partition_window"].items()
        }
        sched.alerts = list(d["alerts"])
        return sched
