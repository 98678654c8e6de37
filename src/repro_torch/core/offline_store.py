"""Offline store (paper §3.1.4, §4.5) — the ADLS/Delta analogue.

Semantics reproduced exactly:
  * records are keyed by IDs + event_timestamp + creation_timestamp;
  * the store keeps EVERY record per ID over time (append-only history);
  * Algorithm 2, offline branch: insert iff the full key does not exist,
    otherwise no-op (idempotent merges make job retries safe — the basis of
    the §4.5.4 eventual-consistency argument);
  * storage partitioning: rows are hash-partitioned by entity key into
    ``num_shards`` shards (the unit of parallel/distributed reads) and each
    shard tracks time-partition statistics (the Delta-table analogue).

Write-path layout (the vectorized merge engine):
  * each shard is a CHUNK LIST — one columnar chunk appended per merge —
    with lazy compaction once the list passes ``compact_threshold``, so a
    merge costs O(batch) (+ amortized compaction), never the
    O(history) concat-per-merge of a single monolithic table;
  * full-key idempotence is enforced against a per-shard SORTED int64 index
    of splitmix-mixed (key, event_ts, creation_ts) record keys
    (``keys.encode_full_keys`` — the same ~2^-64 collision trade the entity
    key codec documents): in-batch dedup via ``np.unique`` (first occurrence
    wins, as in the sequential loop) and store dedup via a C-speed
    ``np.searchsorted`` membership — no Python ``set[tuple]`` bookkeeping,
    no structured-dtype comparisons in the hot path;
  * the per-row reference loop is retained as ``engine="loop"`` for parity
    tests and the old-style benchmark baseline.

Geo-replication surface (core/replication.py consumes all three):
  * ``merge_listeners`` fire after every non-empty merge with the rows the
    merge actually INSERTED (post-dedup, arrival order) — the offline
    plane's shipping unit, mirroring ``OnlineStore.merge``;
  * ``apply_chunks`` is the replica-side apply: the same full-key dedup the
    home merge ran, so re-delivered or bootstrap-overlapping chunks are
    no-ops and a replica converges chunk-set-identical to the home;
  * ``export_chunks`` streams the full history as bounded record-schema
    chunks — the delta-bootstrap source that never materializes a second
    full copy in flight.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np

from repro_torch.core.assets import FeatureSetSpec
from repro_torch.core.keys import encode_full_keys, encode_keys
from repro_torch.core.merge_engine import merge_sorted
from repro_torch.core.monitoring import span
from repro_torch.core.table import Table, concat_tables
from repro_torch.kernels.online_lookup.ops import partition_of

__all__ = ["OfflineStore", "EVENT_TS", "CREATION_TS"]

EVENT_TS = "event_ts"
CREATION_TS = "creation_ts"


def _record_schema(spec: FeatureSetSpec) -> dict[str, np.dtype]:
    schema: dict[str, np.dtype] = {"__key__": np.dtype(np.int64)}
    for k in spec.index_columns:
        schema[k] = np.dtype(np.int64)
    schema[EVENT_TS] = np.dtype(np.int64)
    schema[CREATION_TS] = np.dtype(np.int64)
    for f in spec.features:
        schema[f.name] = f.np_dtype()
    return schema


def _arrival_order(kept_per_shard: list[np.ndarray]) -> np.ndarray:
    """Union of per-shard kept-row indices, back in batch arrival order."""
    if not kept_per_shard:
        return np.empty(0, np.int64)
    return np.sort(np.concatenate(kept_per_shard)).astype(np.int64, copy=False)


def _gather_cols(spec: FeatureSetSpec, source, kept_rows: np.ndarray) -> dict:
    """Index columns (as int64) + feature columns (native dtype) sliced to
    the kept rows.  ``source`` is anything column-indexable — a merge frame
    (``Table``) or a replicated batch's columns dict."""
    cols: dict[str, np.ndarray] = {
        c: np.asarray(source[c], np.int64)[kept_rows] for c in spec.index_columns
    }
    for f in spec.features:
        cols[f.name] = np.asarray(source[f.name], f.np_dtype())[kept_rows]
    return cols


@dataclasses.dataclass
class _Shard:
    chunks: list[Table]
    # sorted int64 full-key hashes for O(log) idempotent-merge checks
    index: np.ndarray = dataclasses.field(default_factory=lambda: np.empty(0, np.int64))
    num_rows: int = 0
    # loop-engine membership set, maintained incrementally so the reference
    # baseline pays seed-equivalent O(batch) per merge (invalidated by
    # vector merges)
    key_set: Optional[set] = None


class OfflineStore:
    """Append-only, history-complete feature record store."""

    def __init__(
        self,
        num_shards: int = 4,
        time_partition: int = 86_400_000,
        *,
        merge_engine: str = "vector",
        compact_threshold: int = 64,
    ):
        self.num_shards = num_shards
        self.time_partition = time_partition
        self.merge_engine = self._normalize_engine(merge_engine)
        self.compact_threshold = compact_threshold
        self._shards: dict[tuple[str, int], list[_Shard]] = {}
        self._specs: dict[tuple[str, int], FeatureSetSpec] = {}
        self.rows_merged = 0
        self.rows_deduped = 0
        # fire after every non-empty merge with (spec, stats); stats carry
        # the inserted rows (the offline replication shipping unit)
        self.merge_listeners: list = []

    @staticmethod
    def _normalize_engine(engine: str) -> str:
        # "kernel" is an online-store notion (device-side compare-and-update);
        # the offline equivalent is the vector path, so accept it here rather
        # than making every caller re-implement the mapping.
        if engine == "kernel":
            return "vector"
        if engine not in ("vector", "loop"):
            raise ValueError(f"unknown merge engine {engine!r}")
        return engine

    # -- lifecycle ----------------------------------------------------------
    def register(self, spec: FeatureSetSpec) -> None:
        key = spec.key
        if key in self._shards:
            return
        schema = _record_schema(spec)
        self._shards[key] = [
            _Shard([Table.empty(schema)]) for _ in range(self.num_shards)
        ]
        self._specs[key] = spec

    def has(self, name: str, version: int) -> bool:
        return (name, version) in self._shards

    # -- Algorithm 2, offline branch -----------------------------------------
    def merge(
        self,
        spec: FeatureSetSpec,
        frame: Table,
        creation_ts: int,
        *,
        engine: Optional[str] = None,
    ) -> int:
        """Merge a materialization-job output frame.  ``frame`` carries index
        columns + event timestamp + features; the store stamps creation_ts
        (the materialization time, always > event_ts).  Returns #rows inserted.
        """
        return self.merge_with_stats(spec, frame, creation_ts, engine=engine)[
            "inserted"
        ]

    def merge_with_stats(
        self,
        spec: FeatureSetSpec,
        frame: Table,
        creation_ts: int,
        *,
        engine: Optional[str] = None,
    ) -> dict:
        """``merge`` returning the full per-batch stats dict.  When (and
        only when) ``merge_listeners`` are subscribed, the stats also carry
        the inserted rows themselves (``inserted_keys/inserted_event_ts/
        inserted_columns``, arrival order) — the reduced form
        geo-replication ships — and the listeners fire with (spec, stats),
        mirroring ``OnlineStore.merge``; a replication listener annotates
        ``stats["replication_seq"]``."""
        engine = self._normalize_engine(engine) if engine else self.merge_engine
        self.register(spec)
        n = len(frame)
        if n == 0:
            return {
                "engine": engine,
                "creation_ts": int(creation_ts),
                "inserted": 0,
                "deduped": 0,
            }
        ids = encode_keys([frame[c] for c in spec.index_columns])
        event_ts = frame[spec.timestamp_col].astype(np.int64)
        if (creation_ts <= event_ts).any():
            raise ValueError(
                "creation_timestamp must exceed every event_timestamp (§4.5.1)"
            )
        if engine == "loop":
            inserted, kept = self._merge_loop(spec, frame, ids, event_ts, creation_ts)
        else:
            inserted, kept = self._merge_vector(spec, frame, ids, event_ts, creation_ts)
        self.rows_merged += inserted
        stats = {
            "engine": engine,
            "creation_ts": int(creation_ts),
            "inserted": inserted,
            "deduped": n - inserted,
        }
        if self.merge_listeners:
            # the inserted-rows payload (a second gather of every column) is
            # only built when a subscriber will ship it — a store without
            # replication attached pays nothing beyond the merge itself
            stats["inserted_keys"] = ids[kept]
            stats["inserted_event_ts"] = event_ts[kept]
            stats["inserted_columns"] = _gather_cols(spec, frame, kept)
            for cb in self.merge_listeners:
                cb(spec, stats)
        return stats

    def _merge_vector(
        self,
        spec: FeatureSetSpec,
        frame: Table,
        ids: np.ndarray,
        event_ts: np.ndarray,
        creation_ts: int,
    ) -> tuple[int, np.ndarray]:
        h = encode_full_keys(ids, event_ts, creation_ts)
        cr_rows = np.full(len(ids), creation_ts, np.int64)
        return self._insert_unique(
            spec, ids, event_ts, cr_rows, h,
            lambda kept_rows: _gather_cols(spec, frame, kept_rows),
        )

    def _insert_unique(
        self,
        spec: FeatureSetSpec,
        ids: np.ndarray,
        event_ts: np.ndarray,
        cr_rows: np.ndarray,
        h: np.ndarray,
        row_cols,
    ) -> tuple[int, np.ndarray]:
        """The vectorized insert-if-absent core shared by home merges
        (``_merge_vector``) and replica applies (``apply_chunks``), so the
        full-key idempotence invariant lives in exactly one place.

        Full-key hashes make both dedup levels primitive int64 ops: ONE
        global sort of the hashes groups duplicate full keys (equal hash ==
        equal triple up to the documented ~2^-64 collision trade), and
        ``minimum.reduceat`` over each equal-hash run recovers the FIRST
        occurrence — exactly the sequential loop's keep-first rule —
        without needing a (much slower for int64) stable sort.  Everything
        downstream operates on the ~unique keys, and store dedup is a
        sorted-array ``searchsorted`` membership probe per shard.

        ``row_cols(kept_rows)`` materializes the chunk's index + feature
        columns for the surviving rows.  Returns (#inserted, kept row
        indices in batch arrival order)."""
        n = len(ids)
        shard_of = partition_of(ids, self.num_shards)
        order = np.argsort(h)
        hs = h[order]
        run_start = np.empty(n, bool)
        run_start[0] = True
        run_start[1:] = hs[1:] != hs[:-1]
        starts = np.flatnonzero(run_start)
        uh_all = hs[starts]  # ascending, unique
        if len(starts) == n:  # common case: no in-batch duplicates at all
            kept_orig = order
        else:
            kept_orig = np.minimum.reduceat(order, starts)  # first arrival
        ushard = shard_of[kept_orig]
        shard_rows = np.bincount(shard_of, minlength=self.num_shards)
        inserted = 0
        kept_all: list[np.ndarray] = []
        for s in range(self.num_shards):
            if shard_rows[s] == 0:
                continue
            shard = self._shards[spec.key][s]
            shard.key_set = None
            msel = ushard == s
            uh = uh_all[msel]  # sorted subsequence
            k = len(shard.index)
            if k:
                pos = np.searchsorted(shard.index, uh)
                member = (pos < k) & (shard.index[np.minimum(pos, k - 1)] == uh)
            else:
                member = np.zeros(len(uh), bool)
            fresh = uh[~member]
            self.rows_deduped += int(shard_rows[s]) - len(fresh)
            if len(fresh) == 0:
                continue
            # chunk rows go back to ORIGINAL arrival order (loop parity)
            kept_rows = np.sort(kept_orig[msel][~member])
            self._append_rows(
                spec,
                shard,
                ids[kept_rows],
                row_cols(kept_rows),
                event_ts[kept_rows],
                cr_rows[kept_rows],
            )
            # the membership probe's positions double as merge positions
            (shard.index,) = merge_sorted(
                [shard.index], [fresh], pos=pos[~member] if k else None
            )
            inserted += len(fresh)
            kept_all.append(kept_rows)
        return inserted, _arrival_order(kept_all)

    def _merge_loop(
        self,
        spec: FeatureSetSpec,
        frame: Table,
        ids: np.ndarray,
        event_ts: np.ndarray,
        creation_ts: int,
    ) -> tuple[int, np.ndarray]:
        """Retained reference: per-row set-membership dedup (the original
        sequential implementation), ending in the same chunk/index state."""
        h = encode_full_keys(ids, event_ts, creation_ts)
        shard_of = partition_of(ids, self.num_shards)
        inserted = 0
        kept_all: list[np.ndarray] = []
        for s in range(self.num_shards):
            mask = shard_of == s
            if not mask.any():
                continue
            shard = self._shards[spec.key][s]
            keys = shard.key_set
            if keys is None:
                keys = set(shard.index.tolist())
                shard.key_set = keys
            rows = np.flatnonzero(mask)
            keep = np.zeros(len(rows), dtype=bool)
            for i, r in enumerate(rows):
                full = int(h[r])
                if full not in keys:
                    keys.add(full)
                    keep[i] = True
            self.rows_deduped += int((~keep).sum())
            if not keep.any():
                continue
            kept_rows = rows[keep]
            self._append_chunk(
                spec, shard, frame, ids, event_ts, creation_ts, kept_rows
            )
            fresh = np.sort(h[kept_rows])
            shard.index = np.insert(
                shard.index, np.searchsorted(shard.index, fresh), fresh
            )
            inserted += len(kept_rows)
            kept_all.append(kept_rows)
        return inserted, _arrival_order(kept_all)

    def _append_chunk(
        self,
        spec: FeatureSetSpec,
        shard: _Shard,
        frame: Table,
        ids: np.ndarray,
        event_ts: np.ndarray,
        creation_ts: int,
        kept_rows: np.ndarray,
    ) -> None:
        """Loop-engine entry into the shared chunk append."""
        self._append_rows(
            spec,
            shard,
            ids[kept_rows],
            _gather_cols(spec, frame, kept_rows),
            event_ts[kept_rows],
            np.full(len(kept_rows), creation_ts, np.int64),
        )

    def _append_rows(
        self,
        spec: FeatureSetSpec,
        shard: _Shard,
        ids_kept: np.ndarray,
        gathered: dict[str, np.ndarray],
        ev_kept: np.ndarray,
        cr_kept: np.ndarray,
    ) -> None:
        """Append one already-deduped chunk to a shard — the single place
        the record-schema column order and lazy compaction live."""
        cols = {"__key__": ids_kept}
        for c in spec.index_columns:
            cols[c] = gathered[c]
        cols[EVENT_TS] = ev_kept
        cols[CREATION_TS] = cr_kept
        for f in spec.features:
            cols[f.name] = gathered[f.name]
        shard.chunks.append(Table(cols))
        shard.num_rows += len(ids_kept)
        if len(shard.chunks) > self.compact_threshold:
            shard.chunks = [concat_tables(shard.chunks)]

    # -- replication apply / export (core/replication.py offline plane) ------
    def apply_chunks(
        self,
        spec: FeatureSetSpec,
        keys: np.ndarray,
        event_ts: np.ndarray,
        creation_ts,
        columns: dict[str, np.ndarray],
    ) -> dict:
        """Idempotently apply replicated rows (a shipped merge batch or a
        bootstrap chunk) with the SAME full-key dedup ``merge`` enforces.

        ``keys`` are the encoded entity keys (``__key__``); ``columns``
        carries the index columns plus native-dtype feature columns;
        ``creation_ts`` is a scalar (live replication: one merge, one stamp)
        or a per-row array (bootstrap chunks span many merges).  Rows whose
        (key, event_ts, creation_ts) full key is already present are
        no-ops, so re-delivery, replay overlap, and an interrupted-then-
        retried bootstrap all converge to the same chunk set."""
        self.register(spec)
        keys = np.asarray(keys, np.int64)
        event_ts = np.asarray(event_ts, np.int64)
        n = len(keys)
        if n == 0:
            return {"applied": 0, "deduped": 0}
        cr = np.asarray(creation_ts, np.int64)
        cr_rows = (
            np.full(n, int(cr), np.int64) if cr.ndim == 0 else cr.astype(np.int64)
        )
        h = encode_full_keys(keys, event_ts, cr_rows)
        applied, _ = self._insert_unique(
            spec, keys, event_ts, cr_rows, h,
            lambda kept_rows: _gather_cols(spec, columns, kept_rows),
        )
        self.rows_merged += applied
        return {"applied": applied, "deduped": n - applied}

    def export_chunks(self, name: str, version: int, *, max_rows: int = 65_536):
        """Yield the full history as bounded record-schema ``Table`` chunks
        (each carries ``__key__`` + index columns + both timestamps +
        features, at most ``max_rows`` rows) — the delta-bootstrap stream.
        Bounded chunks mean a late replica applies the snapshot piecewise
        and never holds a second full copy in flight."""
        for shard in self._shards[(name, version)]:
            for chunk in shard.chunks:
                m = len(chunk)
                for start in range(0, m, max_rows):
                    yield Table(
                        {
                            k: v[start : start + max_rows]
                            for k, v in chunk.columns.items()
                        }
                    )

    def canonical_history(self, name: str, version: int) -> Table:
        """Full history sorted by (key, event_ts, creation_ts) — the chunk-
        layout-independent canonical form replica-equivalence checks
        compare (same full-key set and values <=> equal tables)."""
        t = self.read(name, version)
        if len(t) == 0:
            return t
        order = np.lexsort((t[CREATION_TS], t[EVENT_TS], t["__key__"]))
        return t.take(order)

    # -- reads ---------------------------------------------------------------
    def read(
        self,
        name: str,
        version: int,
        window: Optional[tuple[int, int]] = None,
        shards: Optional[Iterable[int]] = None,
    ) -> Table:
        """Full history (optionally clipped to an event-ts window / shard
        set): every chunk concatenated on each call (span ``offline.read``)."""
        with span("offline.read"):
            shard_list = list(shards) if shards is not None else range(self.num_shards)
            parts = [
                c
                for s in shard_list
                for c in self._shards[(name, version)][s].chunks
            ]
            out = concat_tables(parts)
            if window is not None and len(out):
                ev = out[EVENT_TS]
                out = out.filter((ev >= window[0]) & (ev < window[1]))
            return out

    def latest_per_key(self, name: str, version: int) -> Table:
        """max(tuple(event_ts, creation_ts)) per ID — the §4.5.5
        offline→online bootstrap read."""
        t = self.read(name, version)
        if len(t) == 0:
            return t
        order = np.lexsort((t[CREATION_TS], t[EVENT_TS], t["__key__"]))
        t = t.take(order)
        keys = t["__key__"]
        is_last = np.ones(len(t), dtype=bool)
        is_last[:-1] = keys[:-1] != keys[1:]
        return t.filter(is_last)

    def num_rows(self, name: str, version: int) -> int:
        return sum(s.num_rows for s in self._shards[(name, version)])

    def max_event_ts(self, name: str, version: int) -> Optional[int]:
        t = self.read(name, version)
        return int(t[EVENT_TS].max()) if len(t) else None

    def time_partitions(self, name: str, version: int) -> dict[int, int]:
        """Rows per time partition (Delta-style file statistics)."""
        t = self.read(name, version)
        if len(t) == 0:
            return {}
        part = t[EVENT_TS] // self.time_partition
        uniq, counts = np.unique(part, return_counts=True)
        return {int(u): int(c) for u, c in zip(uniq, counts)}
