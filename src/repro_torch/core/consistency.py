"""Offline/online consistency machinery (paper §4.5.2, §4.5.4, §4.5.5).

  * ``check_consistency`` — the §4.5.2 invariant: for every ID the online
    store holds exactly the offline store's max(tuple(event_ts, creation_ts))
    record (modulo TTL).  This is the "no online/offline skew" test surface.
  * ``bootstrap_offline_to_online`` — read latest-per-ID from offline, dump
    to online (cheap direction).
  * ``bootstrap_online_to_offline`` — dump everything online into offline.

Both bootstraps reuse the Algorithm-2 merges, so they are idempotent and
safe to retry — consistent with the §4.5.4 eventual-consistency story.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.assets import FeatureSetSpec
from repro_torch.core.offline_store import CREATION_TS, EVENT_TS, OfflineStore
from repro_torch.core.online_store import OnlineStore
from repro_torch.core.table import Table

__all__ = [
    "ConsistencyReport",
    "check_consistency",
    "bootstrap_offline_to_online",
    "bootstrap_online_to_offline",
]


@dataclasses.dataclass
class ConsistencyReport:
    consistent: bool
    checked_ids: int
    missing_online: list[int]
    stale_online: list[int]
    missing_offline: list[int]

    def summary(self) -> str:
        if self.consistent:
            return f"consistent ({self.checked_ids} ids)"
        return (
            f"INCONSISTENT: missing_online={len(self.missing_online)} "
            f"stale_online={len(self.stale_online)} "
            f"missing_offline={len(self.missing_offline)}"
        )


def check_consistency(
    spec: FeatureSetSpec, offline: OfflineStore, online: OnlineStore
) -> ConsistencyReport:
    """Vectorized sorted-set comparison: ``latest_per_key`` (lexsorted) and
    ``dump_all`` (index order) are both ascending in ``__key__``, so skew
    checks are searchsorted alignments, not per-id dict probes."""
    latest = offline.latest_per_key(spec.name, spec.version)
    online_dump = online.dump_all(spec.name, spec.version)
    off_k = latest["__key__"] if len(latest) else np.empty(0, np.int64)
    on_k = online_dump["__key__"] if len(online_dump) else np.empty(0, np.int64)
    missing_online = np.setdiff1d(off_k, on_k, assume_unique=True)
    missing_offline = np.setdiff1d(on_k, off_k, assume_unique=True)
    common, off_i, on_i = np.intersect1d(
        off_k, on_k, assume_unique=True, return_indices=True
    )
    stale = (
        (latest[EVENT_TS][off_i] != online_dump[EVENT_TS][on_i])
        | (latest[CREATION_TS][off_i] != online_dump[CREATION_TS][on_i])
        if len(common)
        else np.zeros(0, bool)
    )
    stale_online = common[stale]
    ok = not (len(missing_online) or len(stale_online) or len(missing_offline))
    return ConsistencyReport(
        ok,
        len(off_k),
        [int(k) for k in missing_online],
        [int(k) for k in stale_online],
        [int(k) for k in missing_offline],
    )


def bootstrap_offline_to_online(
    spec: FeatureSetSpec, offline: OfflineStore, online: OnlineStore, now: int
) -> int:
    """§4.5.5: for each ID take max(tuple(event_ts, creation_ts)) from the
    offline history and merge into the online store.  The merge preserves the
    ORIGINAL creation timestamps (a bootstrap is a copy, not a new
    materialization), replayed in creation order so Algorithm 2 semantics
    hold even against records already present online."""
    latest = offline.latest_per_key(spec.name, spec.version)
    online.register(spec)
    n = 0
    # Replay grouped by creation_ts so each merge call has one creation time.
    for cr in np.unique(latest[CREATION_TS]) if len(latest) else []:
        sub = latest.filter(latest[CREATION_TS] == cr)
        frame = _as_feature_frame(spec, sub)
        online.merge(spec, frame, int(cr))
        n += len(sub)
    return n


def bootstrap_online_to_offline(
    spec: FeatureSetSpec, offline: OfflineStore, online: OnlineStore
) -> int:
    """§4.5.5: dump everything in the online store into the offline store."""
    dump = online.dump_all(spec.name, spec.version)
    offline.register(spec)
    n = 0
    for cr in np.unique(dump[CREATION_TS]) if len(dump) else []:
        sub = dump.filter(dump[CREATION_TS] == cr)
        frame = _as_feature_frame(spec, sub)
        offline.merge(spec, frame, int(cr))
        n += len(sub)
    return n


def _as_feature_frame(spec: FeatureSetSpec, records: Table) -> Table:
    """Records (with __key__/event_ts) -> the transform-output frame shape.

    Only valid for single-join-key specs whose key is the raw ID; composite
    keys cannot be inverted from the surrogate, so bootstraps for them carry
    the surrogate key column through (documented limitation of the codec)."""
    cols = {}
    if len(spec.index_columns) == 1:
        cols[spec.index_columns[0]] = records["__key__"]
    else:  # surrogate passthrough
        for c in spec.index_columns:
            cols[c] = records["__key__"]
    cols[spec.timestamp_col] = records[EVENT_TS]
    for f in spec.features:
        cols[f.name] = records[f.name]
    return Table(cols)
