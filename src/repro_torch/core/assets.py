"""Feature-store asset model (paper §2.2, §3.2, §4.1).

Assets are *versioned*: immutable properties (schema, transformation code,
source binding) can only change by incrementing the version; mutable
properties (description, tags, materialization schedule) may be updated in
place.  The registry (registry.py) enforces this contract.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

import numpy as np

from repro_torch.core.table import Table

__all__ = [
    "Entity",
    "Feature",
    "MaterializationSettings",
    "FeatureSetSpec",
    "TransformProtocol",
    "validate_feature_frame",
]


TIMESTAMP_DTYPE = np.int64  # epoch milliseconds everywhere in the system
ID_DTYPE = np.int64


@dataclasses.dataclass(frozen=True)
class Entity:
    """Index/key columns for feature lookup and join (paper §2.2).

    Entities are created once and reused across feature sets; they also
    organize feature sets in the registry.
    """

    name: str
    join_keys: tuple[str, ...]
    description: str = ""
    tags: tuple[str, ...] = ()

    def __post_init__(self) -> None:
        if not self.join_keys:
            raise ValueError(f"entity {self.name!r} needs at least one join key")


@dataclasses.dataclass(frozen=True)
class Feature:
    name: str
    dtype: str = "float32"
    description: str = ""

    def np_dtype(self) -> np.dtype:
        return np.dtype(self.dtype)


class StoreKind(enum.Enum):
    OFFLINE = "offline"
    ONLINE = "online"


@dataclasses.dataclass
class MaterializationSettings:
    """Managed materialization policy (paper §2.2, §4.3).

    ``schedule_interval`` is the cadence of scheduled incremental jobs in
    timestamp units (ms).  ``online_ttl`` models the Redis TTL assumption in
    §4.5.2: online records older than the TTL may be evicted.
    """

    offline_enabled: bool = True
    online_enabled: bool = False
    schedule_interval: Optional[int] = None
    online_ttl: Optional[int] = None
    # Context-aware partitioning scheme (§3.1.1): the unit feature-window size
    # a single materialization job should cover; backfills are split/coalesced
    # into units of this size.  Optionally customer-provided.
    partition_window: Optional[int] = None

    def __post_init__(self) -> None:
        if self.schedule_interval is not None and self.schedule_interval <= 0:
            raise ValueError("schedule_interval must be positive")


class TransformProtocol:
    """A transformation: udf(source_df, context) -> feature_df (paper §4.2).

    Two flavours exist (paper §3.1.6):
      * ``UDFTransform`` — arbitrary user code; a black box to the platform.
      * ``DslTransform`` — declarative rolling-window aggregations that the
        platform lowers to optimized (Pallas) execution.
    Both live in transform.py / dsl.py; this base class only pins the
    interface so FeatureSetSpec can treat them uniformly.
    """

    #: set by subclasses; DSL transforms are optimizable by the query engine.
    is_dsl: bool = False

    def __call__(self, source_df: Table, context: dict[str, Any]) -> Table:
        raise NotImplementedError

    def code_fingerprint(self) -> str:
        """Identity of the transformation logic — an *immutable* property."""
        raise NotImplementedError


@dataclasses.dataclass
class FeatureSetSpec:
    """A feature set: source + transform + schema + materialization (§2.2)."""

    name: str
    version: int
    entity: Entity
    features: tuple[Feature, ...]
    source_name: str
    transform: TransformProtocol
    timestamp_col: str = "ts"
    #: Algorithm 1's source_lookback: how far before the feature window the
    #: source read must start (rolling windows need history).
    source_lookback: int = 0
    materialization: MaterializationSettings = dataclasses.field(
        default_factory=MaterializationSettings
    )
    description: str = ""
    tags: tuple[str, ...] = ()
    #: expected availability delay of source/feature data, honoured by the
    #: point-in-time query subsystem (§4.4).
    expected_delay: int = 0

    def __post_init__(self) -> None:
        if self.version < 1:
            raise ValueError("versions start at 1")
        if self.source_lookback < 0 or self.expected_delay < 0:
            raise ValueError("lookback/delay must be >= 0")
        names = [f.name for f in self.features]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate feature names in {self.name}")
        overlap = set(names) & set(self.entity.join_keys) | (
            {self.timestamp_col} & set(names)
        )
        if overlap:
            raise ValueError(f"feature names collide with keys/ts: {overlap}")

    # -- identity ----------------------------------------------------------
    @property
    def key(self) -> tuple[str, int]:
        return (self.name, self.version)

    @property
    def feature_names(self) -> tuple[str, ...]:
        return tuple(f.name for f in self.features)

    @property
    def index_columns(self) -> tuple[str, ...]:
        return self.entity.join_keys

    def full_feature_names(self) -> tuple[str, ...]:
        """Globally unique names, e.g. ``transactions:v2:sum_30d``."""
        return tuple(f"{self.name}:v{self.version}:{f.name}" for f in self.features)

    # -- immutability contract (§4.1) ---------------------------------------
    def immutable_fingerprint(self) -> tuple:
        """Properties that may never change within a version."""
        return (
            self.name,
            self.version,
            self.entity,
            self.features,
            self.source_name,
            self.timestamp_col,
            self.source_lookback,
            self.transform.code_fingerprint(),
        )


def validate_feature_frame(spec: FeatureSetSpec, frame: Table) -> Table:
    """Enforce the §4.2 output contract: index columns + timestamp column +
    all feature columns declared by the feature set schema."""
    required = (*spec.index_columns, spec.timestamp_col, *spec.feature_names)
    missing = [c for c in required if c not in frame]
    if missing:
        raise ValueError(
            f"feature frame for {spec.name}:v{spec.version} is missing "
            f"required columns {missing}; transform output must contain "
            f"index columns, the timestamp column, and every declared feature"
        )
    return frame.select(required)
