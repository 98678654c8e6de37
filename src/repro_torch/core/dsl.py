"""Feature-transformation DSL (paper §3.1.6).

When customers define features through a UDF, the platform must treat the
transformation as a black box.  When they use the DSL — "a common case is
rolling window aggregation" — the query engine can optimize execution.  Our
optimizer does exactly what the paper sketches ("optimize the aggregation
based on join results"):

  * the (entity, timestamp) sort and per-row window-start index are computed
    ONCE and shared by every aggregation over the same window length;
  * aggregations over the same source column share the loaded column;
  * sum-family aggregations lower to the CUDA rolling-sum kernel
    (kernels/rolling_agg, ``csrc/rolling_sum.cu``) on the transform's
    device, or to its plain version when that device is the CPU;
  * count is closed-form from the shared window indices (zero data reads).

``UDFTransform`` is the black-box path: an arbitrary
``udf(source_df, context) -> feature_df`` per §4.2.
"""

from __future__ import annotations

import dataclasses
import hashlib
import inspect
from typing import Any, Callable, Sequence

import numpy as np
import torch

from repro_torch.core.assets import TransformProtocol
from repro_torch.core.table import Table
from repro_torch.device import resolve_device
from repro_torch.kernels.rolling_agg import ops as rolling_ops

__all__ = ["RollingAgg", "DslTransform", "UDFTransform", "SUPPORTED_AGGS"]

SUPPORTED_AGGS = ("sum", "mean", "count", "min", "max")


@dataclasses.dataclass(frozen=True)
class RollingAgg:
    """``<output> = <agg>(<source_col>) over trailing <window> ms per entity``."""

    output: str
    source_col: str
    window: int
    agg: str

    def __post_init__(self) -> None:
        if self.agg not in SUPPORTED_AGGS:
            raise ValueError(f"agg must be one of {SUPPORTED_AGGS}, got {self.agg!r}")
        if self.window <= 0:
            raise ValueError("window must be positive")


class DslTransform(TransformProtocol):
    """Declarative rolling-window aggregation plan, platform-optimizable."""

    is_dsl = True

    def __init__(
        self,
        entity_col: str | Sequence[str],
        timestamp_col: str,
        aggs: Sequence[RollingAgg],
        *,
        device: str | torch.device = "cuda",
    ) -> None:
        if not aggs:
            raise ValueError("DslTransform needs at least one aggregation")
        self.entity_cols = (
            (entity_col,) if isinstance(entity_col, str) else tuple(entity_col)
        )
        self.timestamp_col = timestamp_col
        self.aggs = tuple(aggs)
        self.device = resolve_device(device)
        outs = [a.output for a in self.aggs]
        if len(set(outs)) != len(outs):
            raise ValueError(f"duplicate DSL outputs: {outs}")

    # -- identity (immutable property of the feature set version) ----------
    def code_fingerprint(self) -> str:
        desc = repr(
            (self.entity_cols, self.timestamp_col,
             tuple((a.output, a.source_col, a.window, a.agg) for a in self.aggs))
        )
        return "dsl:" + hashlib.sha256(desc.encode()).hexdigest()[:16]

    @property
    def max_lookback(self) -> int:
        """What Algorithm 1 must use as ``source_lookback``."""
        return max(a.window for a in self.aggs)

    # -- optimized execution -------------------------------------------------
    def __call__(self, source_df: Table, context: dict[str, Any]) -> Table:
        n = len(source_df)
        # Shared sort by (entity..., ts): done once for the whole plan.
        sort_cols = (*self.entity_cols, self.timestamp_col)
        order = np.lexsort(tuple(source_df[c] for c in reversed(sort_cols)))
        sorted_df = source_df.take(order)
        ts = sorted_df[self.timestamp_col].astype(np.int64)
        seg = self._segment_ids(sorted_df)

        # Shared window-start indices per distinct window length.
        starts_by_window: dict[int, np.ndarray] = {}
        for a in self.aggs:
            if a.window not in starts_by_window:
                starts_by_window[a.window] = (
                    rolling_ops.window_starts(seg, ts, a.window)
                    if n
                    else np.zeros((0,), np.int32)
                )

        # Group sum/mean aggs that share a window so one kernel launch
        # covers all their source columns (columns stacked on the lane dim).
        out_cols: dict[str, np.ndarray] = {
            c: sorted_df[c] for c in (*self.entity_cols, self.timestamp_col)
        }
        kernel_groups: dict[int, list[RollingAgg]] = {}
        for a in self.aggs:
            if a.agg in ("sum", "mean") and n:
                kernel_groups.setdefault(a.window, []).append(a)

        for window, group in kernel_groups.items():
            cols = sorted(set(a.source_col for a in group))
            mat = np.stack([sorted_df[c].astype(np.float32) for c in cols], axis=1)
            sums_t = rolling_ops.rolling_agg(
                torch.from_numpy(mat).to(self.device), starts_by_window[window], "sum"
            )
            sums = sums_t.cpu().numpy()
            # after the download: the kernel's starts report is in
            rolling_ops.check_error(sums_t.device)
            counts = np.arange(n) + 1 - starts_by_window[window]
            for a in group:
                col = sums[:, cols.index(a.source_col)]
                if a.agg == "mean":
                    col = col / np.maximum(counts, 1)
                out_cols[a.output] = col.astype(np.float32)

        for a in self.aggs:
            if a.output in out_cols:
                continue
            starts = starts_by_window[a.window]
            if a.agg == "count":
                out_cols[a.output] = (np.arange(n) + 1 - starts).astype(np.float32)
            elif n == 0:
                out_cols[a.output] = np.zeros((0,), np.float32)
            else:
                vals = sorted_df[a.source_col].astype(np.float32)[:, None]
                out_cols[a.output] = (
                    rolling_ops.rolling_agg(
                        torch.from_numpy(vals).to(self.device), starts, a.agg
                    )
                    .cpu()
                    .numpy()[:, 0]
                    .astype(np.float32)
                )

        return Table(out_cols)

    def _segment_ids(self, sorted_df: Table) -> np.ndarray:
        n = len(sorted_df)
        if n == 0:
            return np.zeros((0,), np.int64)
        change = np.zeros(n, dtype=bool)
        for c in self.entity_cols:
            col = sorted_df[c]
            change[1:] |= col[1:] != col[:-1]
        return np.cumsum(change).astype(np.int64)


class UDFTransform(TransformProtocol):
    """Black-box user code: ``udf(source_df, context) -> feature_df`` (§4.2)."""

    is_dsl = False

    def __init__(self, fn: Callable[[Table, dict[str, Any]], Table], name: str = ""):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "udf")

    def code_fingerprint(self) -> str:
        try:
            src = inspect.getsource(self.fn)
        except (OSError, TypeError):
            src = repr(self.fn)
        return "udf:" + hashlib.sha256(src.encode()).hexdigest()[:16]

    def __call__(self, source_df: Table, context: dict[str, Any]) -> Table:
        return self.fn(source_df, context)
