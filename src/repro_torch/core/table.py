"""Columnar table: the dataframe stand-in for the feature plane.

The paper's Algorithm 1 is a filter -> transform -> filter dataflow over Spark
dataframes.  On a TPU stack there is no Spark; the equivalent substrate is a
columnar batch of host arrays (numpy for mutation-friendly store state) that
compute layers lift to jnp.  A ``Table`` is a thin, schema-checked mapping of
column name -> 1-D (or 2-D for vector features) numpy array with the
relational verbs the feature store needs: filter, sort, concat, take, group.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Mapping, Sequence

import numpy as np

__all__ = ["Table", "concat_tables"]


@dataclasses.dataclass
class Table:
    """An immutable-by-convention columnar table."""

    columns: dict[str, np.ndarray]

    def __post_init__(self) -> None:
        if not self.columns:
            raise ValueError("Table requires at least one column")
        lengths = {k: len(v) for k, v in self.columns.items()}
        if len(set(lengths.values())) > 1:
            raise ValueError(f"ragged columns: {lengths}")
        # Normalize to numpy arrays without copying when possible.
        self.columns = {k: np.asarray(v) for k, v in self.columns.items()}

    # -- basic protocol ----------------------------------------------------
    def __len__(self) -> int:
        return len(next(iter(self.columns.values())))

    def __contains__(self, name: str) -> bool:
        return name in self.columns

    def __getitem__(self, name: str) -> np.ndarray:
        return self.columns[name]

    def __iter__(self) -> Iterator[str]:
        return iter(self.columns)

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(self.columns)

    def num_rows(self) -> int:
        return len(self)

    # -- relational verbs --------------------------------------------------
    def select(self, names: Sequence[str]) -> "Table":
        return Table({n: self.columns[n] for n in names})

    def with_column(self, name: str, values: np.ndarray) -> "Table":
        cols = dict(self.columns)
        cols[name] = np.asarray(values)
        return Table(cols)

    def drop(self, names: Sequence[str]) -> "Table":
        return Table({k: v for k, v in self.columns.items() if k not in set(names)})

    def rename(self, mapping: Mapping[str, str]) -> "Table":
        return Table({mapping.get(k, k): v for k, v in self.columns.items()})

    def filter(self, mask: np.ndarray) -> "Table":
        mask = np.asarray(mask, dtype=bool)
        return Table({k: v[mask] for k, v in self.columns.items()})

    def take(self, indices: np.ndarray) -> "Table":
        return Table({k: v[indices] for k, v in self.columns.items()})

    def sort_by(self, names: Sequence[str]) -> "Table":
        """Stable lexicographic sort; last key in ``names`` is most significant
        to np.lexsort, so reverse to get natural left-to-right priority."""
        keys = tuple(self.columns[n] for n in reversed(names))
        order = np.lexsort(keys)
        return self.take(order)

    def head(self, n: int) -> "Table":
        return Table({k: v[:n] for k, v in self.columns.items()})

    def filter_time_range(self, ts_col: str, start: int, end: int) -> "Table":
        """Rows with start <= ts < end (the paper's half-open feature window)."""
        ts = self.columns[ts_col]
        return self.filter((ts >= start) & (ts < end))

    def group_indices(self, names: Sequence[str]) -> dict[tuple, np.ndarray]:
        """Row indices per distinct key tuple (host-side; used by stores)."""
        keys = [self.columns[n] for n in names]
        out: dict[tuple, list[int]] = {}
        for i in range(len(self)):
            k = tuple(x[i].item() if hasattr(x[i], "item") else x[i] for x in keys)
            out.setdefault(k, []).append(i)
        return {k: np.asarray(v) for k, v in out.items()}

    def map_column(self, name: str, fn: Callable[[np.ndarray], np.ndarray]) -> "Table":
        return self.with_column(name, fn(self.columns[name]))

    def column_stack(
        self, names: Sequence[str], dtype: np.dtype = np.float32
    ) -> np.ndarray:
        """(N, len(names)) matrix of the named columns — the store-facing
        feature plane (one row per record, one column per feature)."""
        if not names:
            return np.zeros((len(self), 0), dtype)
        # np.stack copies anyway; asarray avoids a second copy per column
        # when the dtype already matches
        return np.stack([np.asarray(self.columns[n], dtype) for n in names], axis=1)

    def copy(self) -> "Table":
        return Table({k: v.copy() for k, v in self.columns.items()})

    def to_dict(self) -> dict[str, np.ndarray]:
        return dict(self.columns)

    def equals(self, other: "Table") -> bool:
        if set(self.names) != set(other.names) or len(self) != len(other):
            return False
        return all(np.array_equal(self[k], other[k]) for k in self.names)

    @staticmethod
    def empty(schema: Mapping[str, np.dtype]) -> "Table":
        return Table({k: np.empty((0,), dtype=d) for k, d in schema.items()})


def concat_tables(tables: Sequence[Table]) -> Table:
    tables = [t for t in tables if len(t) > 0] or list(tables[:1])
    if not tables:
        raise ValueError("concat of zero tables")
    names = tables[0].names
    for t in tables[1:]:
        if set(t.names) != set(names):
            raise ValueError(f"schema mismatch: {t.names} vs {names}")
    return Table({n: np.concatenate([t[n] for t in tables]) for n in names})
