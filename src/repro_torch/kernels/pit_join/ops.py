"""The point-in-time search wrapper.

``pit_search`` takes the history's int64 event timestamps as they are: a
CUDA tensor launches ``csrc/pit_search.cu``, a CPU tensor runs the plain
bisection in ``ref.py``.  The JAX package rebased timestamps into int32 for
its TPU kernel and fell back to an oracle when the span did not fit; Hopper
compares int64 natively, so there is no rebase, no span check and no
fallback here.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import native
from repro_torch.kernels.pit_join.ref import pit_search_ref

__all__ = ["counter", "pit_search"]

counter = native.LaunchCounter("pit_search")


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
    m = table_ts.shape[0]
    if max(m, b[0]) >= 2**31:
        raise ValueError("pit_search table and query counts must fit in int32")
    if b[0] and not bool(((q_lo >= 0) & (q_lo <= q_hi) & (q_hi <= m)).all()):
        raise ValueError("segment bounds must satisfy 0 <= lo <= hi <= M")


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
    q_ts."""
    _check_args(table_ts, q_ts, q_lo, q_hi)
    if table_ts.device.type == "cpu":
        return pit_search_ref(table_ts, q_ts, q_lo, q_hi)
    if table_ts.device.type != "cuda":
        raise ValueError(f"pit_search runs on cuda or cpu, not {table_ts.device}")
    b = q_ts.shape[0]
    with torch.cuda.device(table_ts.device):
        lo = q_lo.to(torch.int32)
        hi = q_hi.to(torch.int32)
        idx = torch.empty(b, dtype=torch.int32, device=table_ts.device)
        valid = torch.empty(b, dtype=torch.bool, device=table_ts.device)
        _launch(table_ts, q_ts, lo, hi, idx, valid)
    return idx, valid


def _launch(table_ts, q_ts, lo, hi, idx, valid) -> None:
    """Launch the kernel on checked CUDA tensors (int32 bounds ``lo``/``hi``)
    into ``idx``/``valid`` on the current stream, and count the launch.  No
    queries, no launch: nothing is counted."""
    b = q_ts.shape[0]
    if b == 0:
        return
    err = native.library().pit_search_i64(
        table_ts.data_ptr(), q_ts.data_ptr(), lo.data_ptr(), hi.data_ptr(),
        idx.data_ptr(), valid.data_ptr(), b, torch.cuda.current_stream().cuda_stream,
    )
    native.check(err, "pit_search_i64")
    counter.add()
