"""Reliability runtime (paper §3.1.2–3.1.3).

  * ``Supervisor`` — runs scheduler-issued jobs with retry/backoff, records
    health metrics, raises alerts on non-recoverable failures, and keeps the
    scheduler's state checkpointable between steps.
  * ``SpeculativeExecutor`` — straggler mitigation for sharded work: launch
    the same shard on a backup worker when the primary exceeds the deadline,
    take whichever finishes first (idempotent merges make duplicate
    completion safe — the same §4.5 argument that makes retries safe).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

from repro_torch.core.materializer import Materializer
from repro_torch.core.monitoring import HealthMonitor
from repro_torch.core.scheduler import Scheduler

__all__ = ["Supervisor", "SpeculativeExecutor", "WorkerPool"]


class Supervisor:
    """Drives queued materialization jobs to completion."""

    def __init__(
        self,
        scheduler: Scheduler,
        materializer: Materializer,
        monitor: HealthMonitor,
        *,
        spec_resolver: Callable[[str, int], object],
        source_resolver: Callable[[str], object],
        checkpoint_hook: Optional[Callable[[str], None]] = None,
    ) -> None:
        self.scheduler = scheduler
        self.materializer = materializer
        self.monitor = monitor
        self.spec_resolver = spec_resolver
        self.source_resolver = source_resolver
        self.checkpoint_hook = checkpoint_hook

    def drain(self, max_jobs: Optional[int] = None) -> dict[str, int]:
        """Run queued jobs (retrying failures) until the queue is empty or
        ``max_jobs`` executions happened.  Returns outcome counts."""
        stats = {"succeeded": 0, "retried": 0, "failed": 0}
        executed = 0
        while True:
            runnable = self.scheduler.runnable_jobs()
            if not runnable or (max_jobs is not None and executed >= max_jobs):
                break
            job = runnable[0]
            executed += 1
            self.scheduler.mark_running(job.job_id)
            spec = self.spec_resolver(job.feature_set, job.version)
            source = self.source_resolver(spec.source_name)
            try:
                self.materializer.run_job(job, spec, source)
            except Exception as exc:  # noqa: BLE001 — any job error is retryable
                will_retry = self.scheduler.mark_failed(job.job_id, str(exc))
                self.monitor.record_job(success=False, retried=will_retry)
                if will_retry:
                    stats["retried"] += 1
                else:
                    stats["failed"] += 1
                    self.monitor.alert(self.scheduler.alerts[-1])
            else:
                self.scheduler.mark_succeeded(job.job_id)
                self.monitor.record_job(success=True)
                stats["succeeded"] += 1
            if self.checkpoint_hook:
                self.checkpoint_hook(self.scheduler.to_json())
        return stats


@dataclasses.dataclass
class _ShardRun:
    shard: int
    worker: str
    elapsed: float
    result: object


class WorkerPool:
    """A deterministic simulated worker pool with per-worker speed factors —
    lets tests create stragglers without wall-clock sleeps."""

    def __init__(self, speeds: dict[str, float]):
        if not speeds:
            raise ValueError("need at least one worker")
        self.speeds = speeds  # worker -> multiplier on task cost (1.0 nominal)

    def run(self, worker: str, cost: float, fn: Callable[[], object]) -> _ShardRun:
        start = time.perf_counter()
        result = fn()
        elapsed = time.perf_counter() - start
        # Model the worker's slowness on top of real compute time.
        return _ShardRun(-1, worker, (elapsed + cost) * self.speeds[worker], result)


class SpeculativeExecutor:
    """Deadline-based speculative re-execution of sharded work (§3.1.2)."""

    def __init__(self, pool: WorkerPool, deadline_factor: float = 2.0):
        self.pool = pool
        self.deadline_factor = deadline_factor
        self.speculated: list[int] = []

    def run_shards(
        self,
        shards: list[int],
        fn: Callable[[int], object],
        *,
        shard_cost: float = 1.0,
    ) -> dict[int, object]:
        """Assign shards round-robin; when a worker's modeled latency exceeds
        deadline_factor x the median, re-execute on the fastest worker and
        take the earlier completion."""
        workers = list(self.pool.speeds)
        runs: dict[int, _ShardRun] = {}
        for i, shard in enumerate(shards):
            w = workers[i % len(workers)]
            runs[shard] = self.pool.run(w, shard_cost, lambda s=shard: fn(s))
            runs[shard].shard = shard
        lat = sorted(r.elapsed for r in runs.values())
        median = lat[len(lat) // 2]
        fastest = min(workers, key=lambda w: self.pool.speeds[w])
        for shard, run in list(runs.items()):
            if run.elapsed > self.deadline_factor * median:
                self.speculated.append(shard)
                backup = self.pool.run(fastest, shard_cost, lambda s=shard: fn(s))
                backup.shard = shard
                if backup.elapsed < run.elapsed:
                    runs[shard] = backup
        return {s: r.result for s, r in runs.items()}
