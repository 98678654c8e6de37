"""Online serving front (paper §2.1 item 4, §3.1.4): the request plane in
front of ``OnlineStore``.

The paper's online store exists for one reason — low-latency point lookups
at inference time — but a store reference alone is not a serving tier: at
"millions of users" every caller holding the store would pay a full kernel
dispatch per point GET (the ~ms Pallas dispatch dominates the lookup at
request-sized batches).  This module is the §2.1/§3.1.4 serving tier built
from three mechanisms, each mapped to its paper motivation:

  * MICRO-BATCHED GET SCHEDULER (§3.1.4 "low latency and high throughput
    point lookup"): concurrent point GETs enqueue as ``Ticket``s with a
    deadline; the scheduler coalesces every queued ticket for a table into
    ONE deduplicated, lane-bucketed ``lookup_encoded`` dispatch — the kernel
    cost is paid once per coalesced batch instead of once per caller, which
    is what lets the device-resident kernel path compete with the host path
    at serving time (see benchmarks/bench_serving.py for the measured
    crossover).  Results scatter back to each ticket byte-identical to a
    per-request lookup.
  * HOT-KEY CACHE (§2.1 SLA "data staleness"): a CLOCK (second-chance)
    cache over decoded rows.  Coherence is event-driven, not TTL-driven:
    every ``OnlineStore`` merge fires ``merge_listeners`` with the
    touched-slot keys and the front marks those entries STALE (recording
    the superseding merge's creation_ts) instead of dropping them.  Fresh
    entries serve with staleness zero; stale entries are only eligible for
    DEGRADED serves, and only while ``now - stale_since`` stays within the
    configured ``staleness_bound_ms`` — the "explicit staleness bound" is
    therefore enforced per read, not assumed.  Record TTL (§4.5.2) is
    re-checked at serve time from the cached creation_ts, so an expired row
    serves as a miss exactly like the store would.
  * ADMISSION CONTROL / LOAD SHEDDING (§2.1 "serve features ... with high
    availability"): each dispatch updates a service-rate estimate; a new
    request whose projected queue wait exceeds its deadline budget (or that
    would overflow ``max_queue_keys``) is not queued.  It degrades to a
    bounded-staleness cache serve when every missing key is coverable
    within the staleness bound, and is SHED otherwise — bounded staleness
    before unavailability, unavailability before unbounded queues.

Per-stage latency (queue wait, batch assembly, kernel, decode, end-to-end)
is observed into ``HealthMonitor``'s bounded histograms for every request.

Two clocks, deliberately distinct: the DATA clock (``clock``, logical ms —
the same clock the store's TTL and the §2.1 staleness SLA run on) governs
TTL expiry and staleness bounds; the REQUEST clock (wall ms) governs
deadlines, queue waits, and the latency histograms.  Tests inject both.

The front binds its store through a callable, re-resolved on every
operation: a geo failover that re-points ``FeatureStore.online`` at the
promoted replica is picked up on the next request (cache dropped, merge
listener moved) without the caller doing anything.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional, Union

import numpy as np

from repro_torch.core.keys import encode_keys
from repro_torch.core.monitoring import HealthMonitor, span
from repro_torch.core.online_store import OnlineStore

__all__ = ["HotKeyCache", "ServingConfig", "ServingFront", "Ticket"]

PENDING, DONE, SHED = "pending", "done", "shed"


@dataclasses.dataclass
class ServingConfig:
    """Knobs for the request plane.  The defaults suit a live serving tier;
    ``FeatureStore`` constructs a PASSTHROUGH front (no cache, no admission
    control) unless handed an explicit config, so a plain store keeps its
    exact pre-front semantics and transfer profile."""

    # scheduler: a table's queue dispatches when this many keys are waiting
    # (pump()/flush() dispatch earlier on deadline pressure / explicitly)
    max_batch_keys: int = 4096
    # admission: hard bound on queued keys across all tables
    max_queue_keys: int = 1 << 30
    # default per-request deadline (request-clock ms); None disables
    # projected-wait admission control (hard queue bound still applies)
    deadline_ms: Optional[float] = None
    # hot-key cache capacity in decoded rows; 0 disables caching entirely
    cache_capacity: int = 0
    # max age (data-clock ms since a newer write superseded the row) a
    # DEGRADED serve may return; None forbids serving stale rows at all
    staleness_bound_ms: Optional[int] = 2_000
    # store path a flush dispatches on: "kernel" (device-resident) | "host"
    engine: str = "kernel"


class _Entry:
    __slots__ = ("values", "creation_ts", "found", "stale_since", "ref")

    def __init__(self, values, creation_ts: int, found: bool) -> None:
        self.values = values
        self.creation_ts = creation_ts
        self.found = found
        self.stale_since: Optional[int] = None  # data-clock ms; None = fresh
        self.ref = True  # CLOCK second-chance bit


class HotKeyCache:
    """CLOCK cache over decoded online rows, keyed (table, encoded id).

    CLOCK rather than strict LRU: a hit only sets a reference bit (no
    per-hit reordering), so the zipfian fast path costs one dict probe.
    Negative results are cached too — under power-law traffic a popular
    missing key is as hot as a popular present one.

    Invalidation MARKS rather than drops: a superseded entry remembers
    ``stale_since`` (the creation_ts of the merge that overwrote it), which
    is exactly the quantity the degraded path's staleness bound is defined
    over.  ``mark_stale`` takes the whole touched-key array of a merge and
    intersects it with the cached ids vectorized, so a 100k-row
    materialization merge does not pay a 100k-iteration Python loop to
    invalidate a 10k-entry cache."""

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self._tables: dict[tuple, dict[int, _Entry]] = {}
        self._ring: list[tuple] = []  # (table, id) in insertion order
        self._hand = 0
        self.size = 0
        self.evictions = 0
        self.invalidations = 0

    def get(self, table: tuple, key: int) -> Optional[_Entry]:
        d = self._tables.get(table)
        return d.get(key) if d is not None else None

    def put(
        self, table: tuple, key: int, values, creation_ts: int, found: bool
    ) -> None:
        if self.capacity <= 0:
            return
        d = self._tables.setdefault(table, {})
        e = d.get(key)
        if e is not None:  # refresh in place: entry is fresh again
            e.values = values
            e.creation_ts = creation_ts
            e.found = found
            e.stale_since = None
            e.ref = True
            return
        if self.size >= self.capacity:
            self._evict_one(table, key)
        else:
            self._ring.append((table, key))
            self.size += 1
        d[key] = _Entry(values, creation_ts, found)

    def _evict_one(self, table: tuple, key: int) -> None:
        """Advance the CLOCK hand to a victim, replace it in the ring."""
        ring = self._ring
        while True:
            self._hand %= len(ring)
            vt, vk = ring[self._hand]
            victim = self._tables[vt][vk]
            if victim.ref:
                victim.ref = False
                self._hand += 1
                continue
            del self._tables[vt][vk]
            ring[self._hand] = (table, key)
            self._hand += 1
            self.evictions += 1
            return

    def mark_stale(self, table: tuple, keys: np.ndarray, ts: int) -> None:
        """A merge touched ``keys`` at data-clock ``ts``: any cached row for
        them is now superseded.  The FIRST superseding write defines the
        staleness onset, so an already-stale entry keeps its earlier
        ``stale_since`` (ages monotonically, never resets)."""
        d = self._tables.get(table)
        if not d or len(keys) == 0:
            return
        if len(keys) > len(d):
            cached = np.fromiter(d.keys(), np.int64, len(d))
            keys = cached[np.isin(cached, keys)]
        for k in keys:
            e = d.get(int(k))
            if e is not None and e.stale_since is None:
                e.stale_since = ts
                self.invalidations += 1

    def clear(self) -> None:
        self._tables.clear()
        self._ring.clear()
        self._hand = 0
        self.size = 0


@dataclasses.dataclass
class Ticket:
    """One in-flight GET.  ``values/found/creation_ts`` fill progressively
    (cache rows at admission, store rows at dispatch) and are final once
    ``status == DONE``; a SHED ticket keeps all-miss results."""

    table: tuple
    ids: np.ndarray
    values: np.ndarray
    found: np.ndarray
    creation_ts: np.ndarray
    enqueued_ms: float
    deadline_ms: Optional[float]
    status: str = PENDING
    pending: Optional[np.ndarray] = None  # row indices awaiting the store
    done_ms: float = 0.0
    degraded: bool = False
    stale_age_ms: float = 0.0  # max staleness this ticket was served (ms)

    def result(self) -> tuple[np.ndarray, np.ndarray]:
        return self.values, self.found


class ServingFront:
    def __init__(
        self,
        store: Union[OnlineStore, Callable[[], OnlineStore]],
        *,
        config: Optional[ServingConfig] = None,
        clock: Optional[Callable[[], int]] = None,
        request_clock: Optional[Callable[[], float]] = None,
        monitor: Optional[HealthMonitor] = None,
    ) -> None:
        self._store_ref = store if callable(store) else (lambda: store)
        self.config = config or ServingConfig()
        self.cache = HotKeyCache(self.config.cache_capacity)
        self._clock = clock
        self._rclock = request_clock or (lambda: time.perf_counter() * 1e3)
        self.monitor = monitor
        self._bound: Optional[OnlineStore] = None
        self._listener = None
        self._queues: dict[tuple, deque] = {}
        self._queued_keys: dict[tuple, int] = {}
        self._queued_total = 0
        # EMA of dispatch service rate (keys per request-clock ms); None
        # until the first dispatch measures one
        self._ema_keys_per_ms: Optional[float] = None
        self.max_stale_age_ms = 0.0
        self.counters = {
            "requests": 0,
            "keys": 0,
            "cache_hits": 0,
            "cache_misses": 0,
            "cache_fastpath": 0,
            "degraded": 0,
            "stale_keys_served": 0,
            "shed": 0,
            "dispatches": 0,
            "coalesced_keys": 0,
            "unique_keys": 0,
            "store_keys": 0,
        }

    # -- store binding -------------------------------------------------------
    def _bind(self) -> OnlineStore:
        """Resolve the store, migrating state if the reference re-pointed
        (geo failover): drop the cache (different region's planes), move the
        merge listener.  Queued tickets stay queued — the next flush serves
        them from the new store."""
        store = self._store_ref()
        if store is self._bound:
            return store
        if self._bound is not None and self._listener in self._bound.merge_listeners:
            self._bound.merge_listeners.remove(self._listener)
        self.cache.clear()

        def listener(spec, stats):
            self.cache.mark_stale(
                spec.key, stats["touched_keys"], stats["creation_ts"]
            )

        store.merge_listeners.append(listener)
        self._listener = listener
        self._bound = store
        return store

    # -- clocks / helpers ----------------------------------------------------
    def _data_now(self, now: Optional[int]) -> Optional[int]:
        if now is not None:
            return now
        return self._clock() if self._clock is not None else None

    def _obs(self, name: str, value: float) -> None:
        if self.monitor is not None:
            self.monitor.system.observe(name, value)

    def _inc(self, name: str, by: float = 1.0) -> None:
        self.counters[name] += by
        if self.monitor is not None:
            self.monitor.system.inc(f"serving/{name}", by)

    @staticmethod
    def _expired(entry: _Entry, now: Optional[int], ttl: Optional[int]) -> bool:
        return (
            entry.found
            and now is not None
            and ttl is not None
            and now - entry.creation_ts > ttl
        )

    def _fill_from_entry(self, t: Ticket, row: int, e: _Entry, now, ttl) -> None:
        """Serve one ticket row from a cache entry, applying record TTL the
        way the store would (expired -> miss, zero row)."""
        if e.found and not self._expired(e, now, ttl):
            t.values[row] = e.values
            t.found[row] = True
            t.creation_ts[row] = e.creation_ts

    def est_wait_ms(self, table: tuple, extra_keys: int = 0) -> float:
        """Projected queue wait for a table given the measured service rate
        (0 until the first dispatch calibrates one)."""
        if not self._ema_keys_per_ms:
            return 0.0
        queued = self._queued_keys.get(table, 0) + extra_keys
        return queued / self._ema_keys_per_ms

    # -- admission -----------------------------------------------------------
    def submit(
        self,
        name: str,
        version: int,
        id_columns: Optional[list] = None,
        *,
        ids: Optional[np.ndarray] = None,
        now: Optional[int] = None,
        deadline_ms: Optional[float] = None,
        _default_deadline: bool = True,
    ) -> Ticket:
        """Admit one GET.  Rows the cache can serve fresh are filled
        immediately; the residual enqueues for the next coalesced dispatch.
        Under overload the request degrades to bounded-staleness cache rows
        or is shed — it never joins a queue it cannot clear in time."""
        store = self._bind()
        tkey = (name, version)
        spec = store.spec(name, version)
        if ids is None:
            ids = encode_keys(id_columns)
        else:
            # the ticket outlives this call in self._queues until the next
            # flush; own the ids instead of aliasing the caller's buffer
            # (np.asarray is a no-copy view on dtype match — the
            # ReplicationLog aliasing bug class)
            ids = np.array(ids, np.int64, copy=True)
        if deadline_ms is None and _default_deadline:
            deadline_ms = self.config.deadline_ms
        n = len(ids)
        d = len(spec.features)
        t = Ticket(
            table=tkey,
            ids=ids,
            values=np.zeros((n, d), np.float32),
            found=np.zeros(n, bool),
            creation_ts=np.zeros(n, np.int64),
            enqueued_ms=self._rclock(),
            deadline_ms=deadline_ms,
        )
        self._inc("requests")
        self._inc("keys", n)
        now_l = self._data_now(now)
        ttl = spec.materialization.online_ttl

        pending: list[int] = []
        if self.cache.capacity > 0:
            get = self.cache.get
            for i in range(n):
                e = get(tkey, int(ids[i]))
                if e is not None and e.stale_since is None:
                    e.ref = True
                    self._fill_from_entry(t, i, e, now_l, ttl)
                    self.counters["cache_hits"] += 1
                else:
                    pending.append(i)
                    self.counters["cache_misses"] += 1
        else:
            pending = list(range(n))

        if not pending:
            t.status = DONE
            t.done_ms = self._rclock()
            self._inc("cache_fastpath")
            self._obs("serving/request_us", (t.done_ms - t.enqueued_ms) * 1e3)
            return t

        residual = len(pending)
        overloaded = self._queued_total + residual > self.config.max_queue_keys
        if not overloaded and t.deadline_ms is not None:
            overloaded = self.est_wait_ms(tkey, residual) > t.deadline_ms
        if overloaded:
            return self._degrade_or_shed(t, pending, now_l, ttl)

        t.pending = np.asarray(pending, np.int64)
        self._queues.setdefault(tkey, deque()).append(t)
        self._queued_keys[tkey] = self._queued_keys.get(tkey, 0) + residual
        self._queued_total += residual
        if self._queued_keys[tkey] >= self.config.max_batch_keys:
            self.flush(name, version, now=now_l)
        return t

    def _degrade_or_shed(
        self, t: Ticket, pending: list[int], now_l, ttl
    ) -> Ticket:
        """Overload path: serve every missing row from a cache entry within
        the staleness bound, or shed the whole request.  All-or-nothing — a
        half-stale half-missing answer is not a serving mode."""
        bound = self.config.staleness_bound_ms
        entries = []
        max_age = 0.0
        for i in pending:
            e = self.cache.get(t.table, int(t.ids[i]))
            if e is None:
                entries = None
                break
            if e.stale_since is not None:
                if bound is None or now_l is None:
                    entries = None
                    break
                age = now_l - e.stale_since
                if age > bound:
                    entries = None
                    break
                max_age = max(max_age, float(age))
            entries.append((i, e))
        if entries is None:
            t.status = SHED
            t.done_ms = self._rclock()
            self._inc("shed")
            return t
        nstale = 0
        for i, e in entries:
            self._fill_from_entry(t, i, e, now_l, ttl)
            if e.stale_since is not None:
                nstale += 1
        t.status = DONE
        t.done_ms = self._rclock()
        t.degraded = True
        t.stale_age_ms = max_age
        self.max_stale_age_ms = max(self.max_stale_age_ms, max_age)
        self._inc("degraded")
        self._inc("stale_keys_served", nstale)
        if nstale and self.monitor is not None:
            self.monitor.record_serving_stale_age(max_age)
        self._obs("serving/request_us", (t.done_ms - t.enqueued_ms) * 1e3)
        return t

    # -- scheduling ----------------------------------------------------------
    def pump(self, now: Optional[int] = None, *, force: bool = False) -> int:
        """Dispatch every table whose oldest waiter can no longer afford to
        keep waiting (queue age + projected service time >= deadline).
        Deadline-less tickets are always due.  Returns dispatches run."""
        req_now = self._rclock()
        ran = 0
        for tkey in list(self._queues):
            q = self._queues[tkey]
            if not q:
                continue
            head = q[0]
            due = force or head.deadline_ms is None
            if not due:
                waited = req_now - head.enqueued_ms
                due = waited + self.est_wait_ms(tkey) >= head.deadline_ms
            if due:
                ran += self.flush(*tkey, now=now)
        return ran

    def flush(
        self,
        name: str,
        version: int,
        *,
        engine: Optional[str] = None,
        now: Optional[int] = None,
    ) -> int:
        """Drain a table's queue: coalesce queued tickets into dispatches of
        at most ``max_batch_keys`` keys each (a single over-sized ticket
        still dispatches whole).  Returns the number of dispatches."""
        store = self._bind()
        tkey = (name, version)
        q = self._queues.get(tkey)
        n_dispatch = 0
        cap = self.config.max_batch_keys
        while q:
            batch, nkeys = [], 0
            while q and (not batch or nkeys + len(q[0].pending) <= cap):
                t = q.popleft()
                batch.append(t)
                nkeys += len(t.pending)
            self._queued_keys[tkey] -= nkeys
            self._queued_total -= nkeys
            self._dispatch(store, tkey, batch, engine, now)
            n_dispatch += 1
        return n_dispatch

    def _dispatch(
        self,
        store: OnlineStore,
        tkey: tuple,
        tickets: list[Ticket],
        engine: Optional[str],
        now: Optional[int],
    ) -> None:
        """One coalesced store round-trip for a set of tickets: dedup ->
        cache re-probe -> ONE ``lookup_encoded`` for the residual -> scatter
        rows back -> refill the cache.  Three spans time its stages on every
        dispatch, into the histograms (µs) ``serving/assembly_us`` (dedup
        and cache re-probe), ``serving/kernel_us`` (the whole store round
        trip of ``lookup_encoded``: routing on the host, the probe and
        gather kernels with their uploads and three copies back to the host,
        and the TTL mask; not the kernels alone) and
        ``serving/decode_us`` (cache refill and scatter to the tickets)."""
        engine = engine or self.config.engine
        name, version = tkey
        spec = store.spec(name, version)
        ttl = spec.materialization.online_ttl
        now_l = self._data_now(now)
        d = len(spec.features)
        req_now = self._rclock()
        waits = [(req_now - t.enqueued_ms) * 1e3 for t in tickets]
        if self.monitor is not None:
            self.monitor.system.histograms["serving/queue_wait_us"].observe_batch(
                waits
            )

        sink = self.monitor.system if self.monitor is not None else None
        with span("serving.assembly", sink, "serving/assembly_us") as assembly:
            all_ids = (
                tickets[0].ids[tickets[0].pending]
                if len(tickets) == 1
                else np.concatenate([t.ids[t.pending] for t in tickets])
            )
            uids, inverse = np.unique(all_ids, return_inverse=True)
            uvals = np.zeros((len(uids), d), np.float32)
            ufound = np.zeros(len(uids), bool)
            ucr = np.zeros(len(uids), np.int64)
            # re-probe: an earlier dispatch this flush may have refilled entries
            need: list[int] = []
            if self.cache.capacity > 0:
                get = self.cache.get
                for j in range(len(uids)):
                    e = get(tkey, int(uids[j]))
                    if e is not None and e.stale_since is None:
                        e.ref = True
                        if e.found and not self._expired(e, now_l, ttl):
                            uvals[j] = e.values
                            ufound[j] = True
                            ucr[j] = e.creation_ts
                    else:
                        need.append(j)
            else:
                need = list(range(len(uids)))

        with span("serving.lookup", sink, "serving/kernel_us") as lookup:
            if need:
                miss = np.asarray(need, np.int64)
                vals, found, cr = store.lookup_encoded(
                    name,
                    version,
                    uids[miss],
                    now=now_l,
                    use_kernel=(engine == "kernel"),
                )
                uvals[miss] = vals
                ufound[miss] = found
                ucr[miss] = cr

        with span("serving.decode", sink, "serving/decode_us") as decode:
            if need and self.cache.capacity > 0:
                put = self.cache.put
                for j in need:
                    put(
                        tkey,
                        int(uids[j]),
                        uvals[j].copy(),
                        int(ucr[j]),
                        bool(ufound[j]),
                    )
            res_v = uvals[inverse]
            res_f = ufound[inverse]
            res_c = ucr[inverse]
            off = 0
            done_ms = self._rclock()
            for t in tickets:
                m = len(t.pending)
                t.values[t.pending] = res_v[off : off + m]
                t.found[t.pending] = res_f[off : off + m]
                t.creation_ts[t.pending] = res_c[off : off + m]
                t.pending = None
                t.status = DONE
                t.done_ms = done_ms
                off += m

        self._inc("dispatches")
        self._inc("coalesced_keys", len(all_ids))
        self._inc("unique_keys", len(uids))
        self._inc("store_keys", len(need))
        if self.monitor is not None:
            self.monitor.system.histograms["serving/request_us"].observe_batch(
                [(done_ms - t.enqueued_ms) * 1e3 for t in tickets]
            )
        service_ms = (assembly.seconds + lookup.seconds + decode.seconds) * 1e3
        if service_ms > 0 and len(all_ids):
            rate = len(all_ids) / service_ms
            self._ema_keys_per_ms = (
                rate
                if self._ema_keys_per_ms is None
                else 0.7 * self._ema_keys_per_ms + 0.3 * rate
            )

    # -- synchronous conveniences -------------------------------------------
    def get(
        self,
        name: str,
        version: int,
        id_columns: Optional[list] = None,
        *,
        ids: Optional[np.ndarray] = None,
        now: Optional[int] = None,
        engine: Optional[str] = None,
    ) -> tuple[np.ndarray, np.ndarray]:
        """Single-caller GET: submit + immediate flush of the table (no
        deadline — a synchronous caller is its own deadline), returning
        (values, found) exactly like ``OnlineStore.lookup``.  Concurrent
        tickets already queued for the table ride the same dispatch."""
        t = self.submit(
            name, version, id_columns, ids=ids, now=now, _default_deadline=False
        )
        if t.status == PENDING:
            self.flush(name, version, engine=engine, now=now)
        if t.status == SHED:
            raise RuntimeError(
                f"serving front shed a synchronous GET for {name}:v{version} "
                f"(queue {self._queued_total} keys over budget)"
            )
        return t.result()

    def stats(self) -> dict:
        keyed = self.counters["cache_hits"] + self.counters["cache_misses"]
        return {
            **self.counters,
            "cache_hit_rate": (
                self.counters["cache_hits"] / keyed if keyed else 0.0
            ),
            "cache_size": self.cache.size,
            "cache_evictions": self.cache.evictions,
            "cache_invalidations": self.cache.invalidations,
            "queued_keys": self._queued_total,
            "max_stale_age_ms": self.max_stale_age_ms,
            "est_keys_per_ms": self._ema_keys_per_ms,
        }
