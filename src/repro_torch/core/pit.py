"""Point-in-time correct offline retrieval (paper §4.4).

Given an observation ("spine") table with entity keys and observation
timestamps ts0, join each requested feature set so that every row receives
the feature value from the NEAREST PAST of ts0 — never the future — while
honouring the feature set's expected source/feature delay:

    eligible records:  event_ts <= ts0 - expected_delay
    chosen record:     max event_ts among eligible (break ties by max
                       creation_ts, matching the §4.5 record ordering)

The host sorts the offline store's history by (key, event_ts, creation_ts)
and routes each spine row to its entity's segment; the as-of search runs on
``device`` over the native int64 timestamps (``kernels/pit_join``), in every
span regime: the JAX package's int32 rebase and its wide-span fallback were
TPU workarounds and are gone.  The feature gather stays on the host, as in
the JAX package.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.assets import FeatureSetSpec
from repro_torch.core.keys import encode_keys
from repro_torch.core.offline_store import CREATION_TS, EVENT_TS, OfflineStore
from repro_torch.core.table import Table
from repro_torch.device import resolve_device
from repro_torch.kernels.pit_join import ops as pit_ops
from repro_torch.kernels.pit_join.ref import pit_search_ref

__all__ = ["PitResult", "get_offline_features", "pit_join_feature_set", "search_inputs"]


@dataclasses.dataclass
class PitResult:
    values: dict[str, np.ndarray]  # feature name -> (B,) values
    found: np.ndarray  # (B,) bool
    event_ts: np.ndarray  # (B,) int64 (0 where not found)
    # host seconds of the join's stages: prepare (sort + routing), search
    # (upload, search, download), gather
    seconds: dict[str, float] = dataclasses.field(default_factory=dict)


def _prepare_history(history: Table) -> tuple[Table, np.ndarray, np.ndarray]:
    """Sort history by (key, event_ts, creation_ts); return per-row sorted
    table + unique keys + segment offsets (len = n_unique + 1)."""
    order = np.lexsort((history[CREATION_TS], history[EVENT_TS], history["__key__"]))
    h = history.take(order)
    keys = h["__key__"]
    uniq, first = np.unique(keys, return_index=True)
    offsets = np.concatenate([first, [len(keys)]])
    return h, uniq, offsets


def search_inputs(
    ids: np.ndarray,
    spine_ts: np.ndarray,
    expected_delay: int,
    uniq: np.ndarray,
    offsets: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Route encoded spine ids to their segments of the sorted history:
    (q_ts int64, q_lo int32, q_hi int32, has_entity bool), each (B,).  A row
    whose entity has no history gets the empty range lo == hi."""
    seg = np.searchsorted(uniq, ids)
    seg_clipped = np.clip(seg, 0, len(uniq) - 1)
    has_entity = (seg < len(uniq)) & (uniq[seg_clipped] == ids)
    q_lo = offsets[seg_clipped]
    q_hi = np.where(has_entity, offsets[seg_clipped + 1], q_lo)
    # leakage guard: only the past of ts0, minus the expected delay
    q_ts = np.asarray(spine_ts, np.int64) - expected_delay
    return q_ts, q_lo.astype(np.int32), q_hi.astype(np.int32), has_entity


def pit_join_feature_set(
    spine_keys: list[np.ndarray],
    spine_ts: np.ndarray,
    spec: FeatureSetSpec,
    history: Table,
    *,
    device: str | torch.device = "cuda",
    use_kernel: bool = True,
) -> PitResult:
    """Join one feature set's history onto the spine, point-in-time correct.
    The search runs on ``device``: the kernel where ``use_kernel``, else the
    plain version on the same device."""
    dev = resolve_device(device)
    b = len(spine_ts)
    spine_ts = np.asarray(spine_ts, dtype=np.int64)
    ids = encode_keys(spine_keys)
    empty = PitResult(
        {f.name: np.zeros(b, np.float32) for f in spec.features},
        np.zeros(b, bool),
        np.zeros(b, np.int64),
    )
    if len(history) == 0 or b == 0:
        return empty

    t0 = time.perf_counter()
    h, uniq, offsets = _prepare_history(history)
    table_ev = h[EVENT_TS].astype(np.int64)
    q_ts, q_lo, q_hi, has_entity = search_inputs(
        ids, spine_ts, spec.expected_delay, uniq, offsets
    )

    t1 = time.perf_counter()
    up = lambda a: torch.from_numpy(a).to(dev)
    search = pit_ops.pit_search if use_kernel else pit_search_ref
    idx, valid = search(up(table_ev), up(q_ts), up(q_lo), up(q_hi))
    search_dev = idx.device
    idx, valid = idx.cpu().numpy(), valid.cpu().numpy()
    if use_kernel:  # the download synchronized: the kernel's bounds report is in
        pit_ops.check_error(search_dev)
    valid = valid & has_entity

    t2 = time.perf_counter()
    safe_idx = np.where(valid, idx, 0)
    values = {
        f.name: np.where(valid, h[f.name][safe_idx], 0).astype(np.float32)
        for f in spec.features
    }
    event_out = np.where(valid, table_ev[safe_idx], 0)
    seconds = {"prepare": t1 - t0, "search": t2 - t1, "gather": time.perf_counter() - t2}
    return PitResult(values, valid, event_out, seconds)


def get_offline_features(
    store: OfflineStore,
    spine: Table,
    specs: Sequence[FeatureSetSpec],
    *,
    spine_ts_col: str = "ts",
    device: str | torch.device = "cuda",
    use_kernel: bool = True,
) -> Table:
    """Spine join across many feature sets (the training-data path).

    Output columns: spine columns + ``<fs>:v<n>:<feature>`` per feature +
    ``<fs>:v<n>:__found__`` validity flags (the §4.3 "no data vs. not
    materialized" distinction is surfaced by the caller via the scheduler's
    interval state; here absence of any past record reads as not-found).
    """
    out = dict(spine.to_dict())
    for spec in specs:
        history = store.read(spec.name, spec.version)
        res = pit_join_feature_set(
            [spine[c] for c in spec.index_columns],
            spine[spine_ts_col],
            spec,
            history,
            device=device,
            use_kernel=use_kernel,
        )
        prefix = f"{spec.name}:v{spec.version}"
        for fname, vals in res.values.items():
            out[f"{prefix}:{fname}"] = vals
        out[f"{prefix}:__found__"] = res.found
    return Table(out)
