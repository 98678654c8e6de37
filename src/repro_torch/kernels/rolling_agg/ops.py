"""Rolling-window aggregation for the DSL executor.

  * ``window_starts`` — host-side window-start rows, bit-identical to the
    JAX package's.
  * ``rolling_sum`` — the kernel wrapper: a CUDA tensor launches
    ``csrc/rolling_sum.cu``, a CPU tensor runs the plain float64
    prefix-difference in ``ref.py``.  No span limit on either.
  * ``rolling_agg`` — every aggregation the DSL exposes: count in closed
    form, mean = sum / count, min/max through the exact sparse-table
    formulation in ``ref.py`` (the prefix trick does not apply to them).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import native
from repro_torch.kernels.rolling_agg.ref import rolling_minmax, rolling_sum_ref

__all__ = ["counter", "rolling_agg", "rolling_sum", "window_starts"]

counter = native.LaunchCounter("rolling_sum")


def window_starts(
    segment_ids: np.ndarray, timestamps: np.ndarray, window: int
) -> np.ndarray:
    """Host-side window-start computation (rows sorted by (segment, ts)).

    Window semantics: row j is in row i's window iff same segment and
    ``ts_i - window < ts_j <= ts_i``.  Uses a composite monotone key so one
    global vectorized searchsorted handles every segment at once.
    """
    segment_ids = np.asarray(segment_ids, dtype=np.int64)
    timestamps = np.asarray(timestamps, dtype=np.int64)
    if len(segment_ids) == 0:
        return np.zeros((0,), dtype=np.int32)
    t0 = timestamps.min()
    rebased = timestamps - t0
    span = int(rebased.max()) + 2
    key = segment_ids * span + rebased
    if not np.all(np.diff(key) >= 0):
        raise ValueError("rows must be sorted by (segment, timestamp)")
    q = segment_ids * span + np.maximum(rebased - window, -1)
    starts = np.searchsorted(key, q, side="right")
    return starts.astype(np.int32)


def rolling_sum(values: torch.Tensor, starts: torch.Tensor) -> torch.Tensor:
    """out[i] = sum(values[starts[i] .. i]): values (N, F) float32, starts
    (N,) int32 with 0 <= starts[i] <= i, both on one device -> (N, F)
    float32 on that device."""
    if values.dtype != torch.float32 or starts.dtype != torch.int32:
        raise TypeError(
            f"rolling_sum takes float32 values and int32 starts, got "
            f"{values.dtype}, {starts.dtype}"
        )
    if values.dim() != 2 or starts.shape != (values.shape[0],):
        raise ValueError(
            f"rolling_sum takes values (N, F) and starts (N,), got "
            f"{tuple(values.shape)} and {tuple(starts.shape)}"
        )
    if values.device != starts.device:
        raise ValueError(f"values on {values.device}, starts on {starts.device}")
    if not (values.is_contiguous() and starts.is_contiguous()):
        raise ValueError("rolling_sum takes contiguous values and starts")
    n, f = values.shape
    rows = torch.arange(n, device=starts.device, dtype=torch.int32)
    if n and not bool(((starts >= 0) & (starts <= rows)).all()):
        raise ValueError("window starts must satisfy 0 <= starts[i] <= i")
    if values.device.type == "cpu":
        return rolling_sum_ref(values, starts)
    if values.device.type != "cuda":
        raise ValueError(f"rolling_sum runs on cuda or cpu, not {values.device}")
    lib = native.library()
    with torch.cuda.device(values.device):
        out = torch.empty((n, f), dtype=torch.float32, device=values.device)
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = lib.rolling_sum_f32(
            values.data_ptr(), starts.data_ptr(), out.data_ptr(), n, f, stream
        )
    native.check(err, "rolling_sum_f32")
    counter.add()
    return out


def rolling_agg(values: torch.Tensor, starts: np.ndarray, agg: str) -> torch.Tensor:
    """Public entry used by the DSL executor: values (N, F) float32 on the
    executor's device, ``starts`` host-side (numpy; the DSL computes it from
    host timestamps, which lets the spans be validated eagerly) -> (N, F)
    float32 on the values' device."""
    starts = np.asarray(starts)
    n = values.shape[0]
    if n == 0:
        return torch.zeros((0, values.shape[1]), dtype=torch.float32, device=values.device)
    spans = np.arange(n) + 1 - starts
    if (spans <= 0).any():
        raise ValueError("window starts must satisfy starts[i] <= i")

    if agg == "count":
        cnt = torch.as_tensor(spans, dtype=torch.float32, device=values.device)
        return cnt[:, None].expand(values.shape).contiguous()

    starts_t = torch.as_tensor(starts.astype(np.int32), device=values.device)
    if agg in ("sum", "mean"):
        s = rolling_sum(values.to(torch.float32).contiguous(), starts_t)
        if agg == "sum":
            return s
        cnt = torch.as_tensor(spans, dtype=torch.float32, device=values.device)[:, None]
        return s / torch.clamp_min(cnt, 1.0)

    if agg in ("min", "max"):
        return rolling_minmax(values, starts_t, agg)

    raise ValueError(f"unknown agg {agg!r}")
