"""The point-in-time search wrapper.

``pit_search`` takes the history's int64 event timestamps as they are: a
CUDA tensor launches ``csrc/pit_search.cu``, a CPU tensor runs the plain
bisection in ``ref.py``.  The JAX package rebased timestamps into int32 for
its TPU kernel and fell back to an oracle when the span did not fit; Hopper
compares int64 natively, so there is no rebase, no span check and no
fallback here.

The segment bounds are data, so on the card they are checked by the kernel,
not by a synchronizing reduction here: a query whose bounds fail
0 <= lo <= hi <= M gets valid = False and sets its device's word in
``errors``.  The reliable read is after a synchronization: ``core/pit.py``
after its download of the results, ``check_error`` for a direct caller
after ``torch.cuda.synchronize()``.  The next launch on the device reads
the word too, as a best-effort net whose timing is not fixed
(``native.ErrorWord``).  The CPU path checks eagerly and reads no word.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import native
from repro_torch.kernels.pit_join.ref import pit_search_ref

__all__ = ["check_error", "counter", "errors", "pit_search"]

BOUNDS_MESSAGE = "segment bounds must satisfy 0 <= lo <= hi <= M"

counter = native.LaunchCounter("pit_search")
errors = native.ErrorWord(BOUNDS_MESSAGE)


def check_error(device: torch.device | str | None = None) -> None:
    """Raise ``ValueError`` if a launch on ``device`` (on any device where
    None) since the last check had bounds outside 0 <= lo <= hi <= M, and
    clear the report.  Reliable after a synchronization of the device: it
    sees the launches that finished before it."""
    errors.raise_if_set(device)


def _check_args(table_ts, q_ts, q_lo, q_hi) -> None:
    if table_ts.dtype != torch.int64 or q_ts.dtype != torch.int64:
        raise TypeError(
            f"pit_search takes int64 timestamps, got {table_ts.dtype}, {q_ts.dtype}"
        )
    if q_lo.dtype not in (torch.int32, torch.int64) or q_hi.dtype not in (
        torch.int32, torch.int64
    ):
        raise TypeError(f"pit_search takes int32/int64 bounds, got {q_lo.dtype}, {q_hi.dtype}")
    b = q_ts.shape
    if table_ts.dim() != 1 or q_ts.dim() != 1 or q_lo.shape != b or q_hi.shape != b:
        raise ValueError(
            f"pit_search takes table_ts (M,) and q_ts/q_lo/q_hi (B,), got "
            f"{tuple(table_ts.shape)}, {tuple(q_ts.shape)}, {tuple(q_lo.shape)}, "
            f"{tuple(q_hi.shape)}"
        )
    devices = {t.device for t in (table_ts, q_ts, q_lo, q_hi)}
    if len(devices) != 1:
        raise ValueError(f"pit_search takes tensors on one device, got {devices}")
    if not all(t.is_contiguous() for t in (table_ts, q_ts, q_lo, q_hi)):
        raise ValueError("pit_search takes contiguous tensors")
    if max(table_ts.shape[0], b[0]) >= 2**31 - 1:
        raise ValueError("pit_search table and query counts must fit in int32")


def pit_search(
    table_ts: torch.Tensor,
    q_ts: torch.Tensor,
    q_lo: torch.Tensor,
    q_hi: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """table_ts (M,) int64 sorted within every [lo, hi) segment; q_ts (B,)
    int64; q_lo/q_hi (B,) int32 or int64 with 0 <= lo <= hi <= M, all on one
    device.

    Returns (idx (B,) int32, valid (B,) bool): the greatest r in [lo, hi)
    with table_ts[r] <= q_ts (ties in ts resolve to the last such row), or
    valid=False (idx = lo - 1) when the segment has no row at or before
    q_ts.  On the card, bounds outside 0 <= lo <= hi <= M raise at a later
    read of ``errors`` (see the module's docstring); such a query gets
    valid=False and idx=-1."""
    _check_args(table_ts, q_ts, q_lo, q_hi)
    m = table_ts.shape[0]
    if table_ts.device.type == "cpu":
        if len(q_ts) and not bool(((q_lo >= 0) & (q_lo <= q_hi) & (q_hi <= m)).all()):
            raise ValueError(BOUNDS_MESSAGE)
        return pit_search_ref(table_ts, q_ts, q_lo, q_hi)
    if table_ts.device.type != "cuda":
        raise ValueError(f"pit_search runs on cuda or cpu, not {table_ts.device}")
    b = q_ts.shape[0]
    with torch.cuda.device(table_ts.device):
        # int64 bounds outside [-1, M + 1] would wrap in int32: clamped, they
        # still fail the kernel's check
        lo, hi = (q.to(torch.int32) if q.dtype == torch.int32
                  else q.clamp(-1, m + 1).to(torch.int32) for q in (q_lo, q_hi))
        idx = torch.empty(b, dtype=torch.int32, device=table_ts.device)
        valid = torch.empty(b, dtype=torch.bool, device=table_ts.device)
        _launch(table_ts, q_ts, lo, hi, idx, valid)
    return idx, valid


def _launch(table_ts, q_ts, lo, hi, idx, valid) -> None:
    """Launch the kernel on checked CUDA tensors (int32 bounds ``lo``/``hi``)
    into ``idx``/``valid`` on the current stream, and count the launch;
    first raise an unread report of the device.  No queries, no launch:
    nothing is counted."""
    b = q_ts.shape[0]
    if b == 0:
        return
    errors.raise_if_set(table_ts.device)
    err = native.library().pit_search_i64(
        table_ts.data_ptr(), q_ts.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        idx.data_ptr(), valid.data_ptr(), errors.ptr(table_ts.device), table_ts.shape[0], b,
        torch.cuda.current_stream().cuda_stream,
    )
    native.check(err, "pit_search_i64")
    counter.add()
