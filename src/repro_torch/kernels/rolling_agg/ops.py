"""Rolling-window aggregation for the DSL executor.

  * ``window_starts`` — host-side window-start rows, bit-identical to the
    JAX package's.
  * ``rolling_sum`` — the kernel wrapper: a CUDA tensor launches
    ``csrc/rolling_sum.cu``, a CPU tensor runs the plain float64
    prefix-difference in ``ref.py``.  No span limit on either.  On the card
    the starts are checked by the kernel, not by a synchronizing reduction
    here: a row whose start fails 0 <= starts[i] <= i gets NaN and sets its
    device's word in ``errors``.  The reliable read is after a
    synchronization: ``core/dsl.py`` after its download of the sums,
    ``check_error`` for a direct caller after ``torch.cuda.synchronize()``.
    The next launch on the device reads the word too, as a best-effort net
    whose timing is not fixed (``native.ErrorWord``).  The CPU path checks
    eagerly and reads no word.
  * ``rolling_agg`` — every aggregation the DSL exposes: count in closed
    form, mean = sum / count, min/max through the exact sparse-table
    formulation in ``ref.py`` (the prefix trick does not apply to them).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import native
from repro_torch.kernels.rolling_agg.ref import rolling_minmax, rolling_sum_ref

__all__ = ["check_error", "counter", "errors", "rolling_agg", "rolling_sum",
           "window_starts"]

STARTS_MESSAGE = "window starts must satisfy 0 <= starts[i] <= i"
# rows of the kernel's tile (kTile in csrc/rolling_sum.cu), which sizes its
# float64 scratch: N*F local prefixes, and F tile totals and their scan per tile
TILE_ROWS = 1024

# one count per call of the C entry, which launches ceil(F / 4) tile
# kernels, the scan of the tile totals and the cross-tile pass
counter = native.LaunchCounter("rolling_sum")
errors = native.ErrorWord(STARTS_MESSAGE)


def check_error(device: torch.device | str | None = None) -> None:
    """Raise ``ValueError`` if a launch on ``device`` (on any device where
    None) since the last check had a start outside 0 <= starts[i] <= i, and
    clear the report.  Reliable after a synchronization of the device: it
    sees the launches that finished before it."""
    errors.raise_if_set(device)


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
    float32 on that device.  On the card a bad start raises at a later read
    of ``errors`` (see the module's docstring) and its row is NaN."""
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
    if values.device.type == "cpu":
        rows = torch.arange(n, dtype=torch.int32)
        if n and not bool(((starts >= 0) & (starts <= rows)).all()):
            raise ValueError(STARTS_MESSAGE)
        return rolling_sum_ref(values, starts)
    if values.device.type != "cuda":
        raise ValueError(f"rolling_sum runs on cuda or cpu, not {values.device}")
    with torch.cuda.device(values.device):
        out = torch.empty((n, f), dtype=torch.float32, device=values.device)
        scratch = torch.empty(scratch_len(n, f), dtype=torch.float64,
                              device=values.device)
        _launch(values, starts, out, scratch)
    return out


def scratch_len(n: int, f: int) -> int:
    """float64 elements of the kernel's scratch for values (n, f)."""
    return (n + 2 * -(-n // TILE_ROWS)) * f


def _launch(values, starts, out, scratch) -> None:
    """Launch the kernel on checked CUDA tensors into ``out`` on the current
    stream, with ``scratch`` (``scratch_len`` float64 elements), and count
    the launch; first raise an unread report of the device.  Nothing to sum,
    no launch: nothing is counted."""
    n, f = values.shape
    if n * f == 0:
        return
    errors.raise_if_set(values.device)
    err = native.library().rolling_sum_f32(
        values.data_ptr(), starts.data_ptr(), out.data_ptr(), scratch.data_ptr(),
        scratch.numel(), errors.ptr(values.device), n, f,
        torch.cuda.current_stream().cuda_stream,
    )
    native.check(err, "rolling_sum_f32")
    counter.add()


def rolling_agg(values: torch.Tensor, starts: np.ndarray, agg: str) -> torch.Tensor:
    """Public entry used by the DSL executor: values (N, F) float32 on the
    executor's device, ``starts`` host-side (numpy; the DSL computes it from
    host timestamps, which lets the spans be validated eagerly) -> (N, F)
    float32 on the values' device."""
    starts = np.asarray(starts)
    n = values.shape[0]
    if n == 0:
        return torch.zeros((0, values.shape[1]), dtype=torch.float32,
                           device=values.device)
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
