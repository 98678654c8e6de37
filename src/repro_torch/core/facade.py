"""The ONE store surface (paper §2.1's functional facade, made explicit).

``FeatureStore`` (single region), ``GeoFeatureStore`` (single-home
geo-replicated), and ``MultiHomeGeoStore`` (active-active sharded) grew up
separately; serving code, examples, and benchmarks used to program against
whichever concrete surface they were handed — including an implicit
``__getattr__`` passthrough on ``GeoFeatureStore`` that made the real API
invisible.  ``StoreFacade`` names the shared contract instead: asset
registration, batch writes, online GET, replication lag, failover/rejoin,
drain.  All three stores satisfy it (asserted by ``isinstance`` in the
facade tests — the protocol is runtime-checkable), and anything driving "a
store" should take a ``StoreFacade``, not a concrete class.

The degenerate cases are explicit rather than papered over: a single-region
``FeatureStore`` reports zero lag, has nothing to fail over, and raises on
``rejoin`` — the honest answers, not missing attributes.
"""

from __future__ import annotations

from typing import Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.assets import FeatureSetSpec
from repro_torch.core.table import Table

__all__ = ["StoreFacade"]


@runtime_checkable
class StoreFacade(Protocol):
    """What every store front answers for: writes, online reads, lag,
    failover/rejoin, drain.  ``runtime_checkable`` — tests assert each
    concrete store satisfies it (method presence; signatures are enforced
    by the shared facade test exercising each method for real)."""

    def create_feature_set(self, spec: FeatureSetSpec) -> FeatureSetSpec:
        """Register one feature set (every region/plane that serves it)."""
        ...

    def write_batch(
        self,
        name: str,
        version: int,
        frame: Table,
        *,
        creation_ts: Optional[int] = None,
        region: Optional[str] = None,
    ) -> dict:
        """Ingest one frame.  ``region`` is where the write LANDS: ignored
        by single-region stores, the home region for single-home geo
        (writes always land there), and the entry region for multi-home
        (the batch splits by owning shard from there)."""
        ...

    def get_online_features(
        self, name: str, version: int, id_columns: list[np.ndarray], **kwargs
    ) -> tuple:
        """Online GET: (values, found[, route]) — geo stores append the
        routing record."""
        ...

    def lag(self, region: str):
        """Replication lag of one region as a ``replication.LagStats``
        (all-zeros for the home / a single-region store)."""
        ...

    def drain(self, region: Optional[str] = None) -> dict:
        """Ship pending replication (no-op dict for single-region)."""
        ...

    def failover(self, region: Optional[str] = None):
        """React to a lost region: promote its range(s)/store to the
        nearest in-sync replica.  None when there is nothing to do."""
        ...

    def rejoin(self, region: str, **kwargs) -> dict:
        """Re-admit a recovered region via delta bootstrap."""
        ...
