"""Carry online-store state between the JAX package and the port as numpy.

``online_table_from_numpy`` installs one table's host state (the arrays a
JAX ``OnlineStore`` table holds) into a port ``OnlineStore``, which uploads
it to its device at its next kernel operation; ``_to_numpy`` reads a port
table back out in the same form.  The JAX store's int32 key planes are not
part of that state: ``keys_full`` carries the same keys as int64.
"""

from __future__ import annotations

from collections import deque

import numpy as np

from repro_torch.core.assets import FeatureSetSpec
from repro_torch.core.online_store import OnlineStore, _PartitionedTable

__all__ = ["STATE_FIELDS", "online_table_from_numpy"]

STATE_FIELDS = (
    "keys_full", "event_ts", "creation_ts", "values", "fill",
    "idx_keys", "idx_part", "idx_slot",
)
_DTYPES = {
    "keys_full": np.int64, "event_ts": np.int64, "creation_ts": np.int64,
    "values": np.float32, "fill": np.int64,
    "idx_keys": np.int64, "idx_part": np.int64, "idx_slot": np.int64,
}


def online_table_from_numpy(
    store: OnlineStore, spec: FeatureSetSpec, state: dict
) -> None:
    """Install ``state`` (``STATE_FIELDS`` arrays plus ``free``, a list of P
    sequences of freed slots) as ``spec``'s table in ``store``, replacing
    any table it held.  The arrays are copied; shapes are checked against
    the store's partition count and the spec's feature width."""
    p = store.num_partitions
    arrays = {k: np.array(state[k], dtype=_DTYPES[k], copy=True) for k in STATE_FIELDS}
    c = arrays["keys_full"].shape[1] if arrays["keys_full"].ndim == 2 else -1
    expect = {
        "keys_full": (p, c), "event_ts": (p, c), "creation_ts": (p, c),
        "values": (p, c, len(spec.features)), "fill": (p,),
    }
    for k, shape in expect.items():
        if arrays[k].shape != shape:
            raise ValueError(f"{k} has shape {arrays[k].shape}, expected {shape}")
    k = len(arrays["idx_keys"])
    if arrays["idx_part"].shape != (k,) or arrays["idx_slot"].shape != (k,):
        raise ValueError("idx_keys, idx_part and idx_slot must have one length")
    if len(state["free"]) != p:
        raise ValueError(f"free needs one list per partition ({p})")
    store._tables[spec.key] = _PartitionedTable(
        **arrays, free=[deque(int(s) for s in f) for f in state["free"]]
    )
    store._specs[spec.key] = spec


def _to_numpy(store: OnlineStore, name: str, version: int) -> dict:
    """One port table's host state (synced from device truth first), as the
    arrays ``online_table_from_numpy`` takes, copied."""
    store.sync_host_mirrors(name, version)
    t = store._tables[(name, version)]
    out = {k: np.array(getattr(t, k), copy=True) for k in STATE_FIELDS}
    out["free"] = [list(f) for f in t.free]
    return out
