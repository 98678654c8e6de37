"""Feature calculation flow — the paper's Algorithm 1, verbatim dataflow.

    source_window_start = feature_window_start - source_lookback
    df1 = source.read(...).filter(source_window)
    df2 = transform(df1)
    feature_df = df2.filter(feature_window)

The same flow is used by materialization jobs (incremental and backfill) and
by on-the-fly offline joins of non-materialized feature sets (§4.2).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Protocol

import numpy as np

from repro_torch.core.assets import FeatureSetSpec, validate_feature_frame
from repro_torch.core.table import Table

__all__ = ["SourceProtocol", "FeatureWindow", "compute_feature_window"]


class SourceProtocol(Protocol):
    """A time-addressable source system (paper Fig. 2 'data sources')."""

    name: str

    def read(self, start_ts: int, end_ts: int) -> Table:
        """Rows with start_ts <= ts < end_ts."""
        ...


@dataclasses.dataclass(frozen=True, order=True)
class FeatureWindow:
    """Half-open [start, end) window on the feature event timeline."""

    start: int
    end: int

    def __post_init__(self) -> None:
        if self.end <= self.start:
            raise ValueError(f"empty window [{self.start}, {self.end})")

    def overlaps(self, other: "FeatureWindow") -> bool:
        return self.start < other.end and other.start < self.end

    @property
    def length(self) -> int:
        return self.end - self.start


def compute_feature_window(
    spec: FeatureSetSpec,
    source: SourceProtocol,
    window: FeatureWindow,
    context: dict[str, Any] | None = None,
) -> Table:
    """Algorithm 1: read lookback-extended source, transform, clip to window."""
    if source.name != spec.source_name:
        raise ValueError(
            f"feature set {spec.name} is bound to source {spec.source_name!r}, "
            f"got {source.name!r}"
        )
    ctx = dict(context or {})
    ctx.setdefault("feature_window", window)

    source_start = window.start - spec.source_lookback
    df1 = source.read(source_start, window.end)

    df2 = spec.transform(df1, ctx)
    df2 = validate_feature_frame(spec, df2)

    ts = df2[spec.timestamp_col].astype(np.int64)
    feature_df = df2.filter((ts >= window.start) & (ts < window.end))
    return feature_df
