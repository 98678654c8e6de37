"""Host routing and the device GET for the online store.

  * ``pow2_bucket`` / ``split_i64`` / ``combine_i64`` / ``partition_of`` /
    ``route_flat`` / ``route_queries`` — the numpy routing helpers the store,
    the offline shards and the kernels share, bit-identical to the JAX
    package's so both place every key in the same partition.
  * ``route_queries_i64`` — the routed (P, Q) int64 query plane the CUDA
    kernel takes, bucketed exactly like ``route_queries`` so transfer sizes
    match the JAX store's.
  * ``lookup`` — the kernel wrapper: int64 keys (P, C) against routed int64
    queries (P, Q) -> (P, Q) int32 slots.  A CUDA tensor launches
    ``csrc/online_lookup.cu`` once, into an output it does not zero, and
    does not synchronize; a CPU tensor runs the plain version in ``ref.py``.
    With the key plane resident on the card, only the routed queries go up
    and the slots come back: O(batch), never O(P*C).
  * ``gather_rows`` — the resident GET's second half: feature rows and
    creation_ts at resolved (part, slot) coords, on the table's device.
  * ``route_and_lookup`` — the flat numpy-in / numpy-out GET: route, look
    up and gather on ``device``, un-permute.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import native
from repro_torch.kernels.online_lookup.ref import lookup_ref

__all__ = [
    "combine_i64",
    "counter",
    "gather_rows",
    "lookup",
    "partition_of",
    "pow2_bucket",
    "route_and_lookup",
    "route_flat",
    "route_queries",
    "route_queries_i64",
    "split_i64",
]

_LANE = 128
_MIX = np.uint64(0x9E3779B97F4A7C15)

counter = native.LaunchCounter("online_lookup")


def pow2_bucket(n: int, floor: int = _LANE) -> int:
    """Round a host-side length up to a power of two (>= ``floor``) — the ONE
    shape-bucketing rule every device op on the GET/merge path uses, so the
    transfer sizes of a stream of varying batches fall into log2 buckets."""
    b = floor
    while b < n:
        b *= 2
    return b


def split_i64(ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """int64 -> (lo, hi) int32 planes (two's-complement faithful)."""
    u = np.asarray(ids, dtype=np.int64).view(np.uint64)
    lo = (u & np.uint64(0xFFFFFFFF)).astype(np.uint32).view(np.int32)
    hi = (u >> np.uint64(32)).astype(np.uint32).view(np.int32)
    return lo, hi


def combine_i64(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """(lo, hi) int32 planes -> int64 (inverse of ``split_i64``)."""
    u = np.asarray(lo).view(np.uint32).astype(np.uint64) | (
        np.asarray(hi).view(np.uint32).astype(np.uint64) << np.uint64(32)
    )
    return u.view(np.int64)


def partition_of(ids: np.ndarray, num_partitions: int) -> np.ndarray:
    """Fibonacci-hash partition routing (identical for store + queries)."""
    u = np.asarray(ids, dtype=np.int64).view(np.uint64)
    mixed = (u * _MIX) >> np.uint64(33)
    if num_partitions & (num_partitions - 1) == 0:
        # power-of-two partition counts (the default) take the cheap mask;
        # uint64 modulo costs ~2.5ms per 100k keys on its own
        return (mixed & np.uint64(num_partitions - 1)).view(np.int64)
    return (mixed % np.uint64(num_partitions)).astype(np.int64)


def route_flat(
    num_partitions: int, ids: np.ndarray, *payloads: np.ndarray
) -> tuple[np.ndarray, ...]:
    """Vectorized flat->routed scatter shared by the lookup and merge paths.

    ids (B,) -> (routed_ids (P, Qmax) int64 with -2 padding, part (B,),
    pos (B,) [each row's slot within its partition], *routed payloads
    (P, Qmax, ...) zero-padded).
    """
    b = len(ids)
    part = partition_of(ids, num_partitions)
    counts = np.bincount(part, minlength=num_partitions)
    q_max = max(int(counts.max()) if b else 0, 1)
    order = np.argsort(part, kind="stable")
    ps = part[order]
    # rank of each row within its partition's contiguous block
    pos_sorted = np.arange(b) - np.searchsorted(ps, ps)
    pos = np.empty(b, np.int64)
    pos[order] = pos_sorted
    routed_ids = np.full((num_partitions, q_max), -2, np.int64)
    routed_ids[part, pos] = ids
    out = [routed_ids, part, pos]
    for payload in payloads:
        shape = (num_partitions, q_max) + payload.shape[1:]
        r = np.zeros(shape, payload.dtype)
        r[part, pos] = payload
        out.append(r)
    return tuple(out)


def route_queries_i64(
    num_partitions: int, ids: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Route a flat id batch into the kernel's (P, Q) int64 query plane.

    Returns (routed, part, pos): ``routed`` padded to a power-of-two lane
    bucket (``pow2_bucket``) with every pad entry -2, which matches neither a
    live key (>= 0) nor an empty slot (-1).  ``part``/``pos`` un-permute
    kernel results back to batch order."""
    routed_ids, part, pos = route_flat(num_partitions, ids)[:3]
    qmax = routed_ids.shape[1]
    qpad = pow2_bucket(qmax)
    if qpad != qmax:
        routed_ids = np.concatenate(
            [routed_ids, np.full((num_partitions, qpad - qmax), -2, np.int64)],
            axis=1,
        )
    return routed_ids, part, pos


def route_queries(
    num_partitions: int, ids: np.ndarray
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """``route_queries_i64`` as the JAX package's (q_lo, q_hi) int32 planes,
    with every pad stamped to the (-2, -2) sentinel: (q_lo, q_hi, part, pos)."""
    routed_ids, part, pos = route_queries_i64(num_partitions, ids)
    q_lo, q_hi = split_i64(routed_ids)
    pad = routed_ids == -2
    q_lo[pad] = -2
    q_hi[pad] = -2
    return q_lo, q_hi, part, pos


def _check_lookup_args(keys: torch.Tensor, queries: torch.Tensor) -> None:
    if keys.dtype != torch.int64 or queries.dtype != torch.int64:
        raise TypeError(
            f"lookup takes int64 keys and queries, got {keys.dtype}, {queries.dtype}")
    if keys.dim() != 2 or queries.dim() != 2 or keys.shape[0] != queries.shape[0]:
        raise ValueError(
            f"lookup takes keys (P, C) and queries (P, Q), got "
            f"{tuple(keys.shape)} and {tuple(queries.shape)}"
        )
    if keys.device != queries.device:
        raise ValueError(f"keys on {keys.device}, queries on {queries.device}")
    if not (keys.is_contiguous() and queries.is_contiguous()):
        raise ValueError("lookup takes contiguous keys and queries")
    if max(keys.shape[1], queries.shape[1], keys.shape[0]) >= 2**31:
        raise ValueError("lookup dimensions must fit in int32")


def lookup(keys: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Pre-routed GET: keys (P, C) int64, queries (P, Q) int64 -> (P, Q)
    int32 slot of the matching key (the largest if several match), -1 if
    none.  Runs where the tensors lie: CUDA launches the kernel, CPU runs
    the plain version."""
    _check_lookup_args(keys, queries)
    if keys.device.type == "cpu":
        return lookup_ref(keys, queries)
    if keys.device.type != "cuda":
        raise ValueError(f"lookup runs on cuda or cpu, not {keys.device}")
    with torch.cuda.device(keys.device):
        out = torch.empty(queries.shape, dtype=torch.int32, device=keys.device)
        _launch(keys, queries, out)
    return out


def _launch(keys: torch.Tensor, queries: torch.Tensor, out: torch.Tensor) -> None:
    """Launch the kernel on checked CUDA tensors into ``out`` (every entry
    written) on the current stream, and count the launch.  No queries, no
    launch: nothing is counted."""
    p, c = keys.shape
    q = queries.shape[1]
    if p * q == 0:
        return
    err = native.library().online_lookup_i64(
        keys.data_ptr(), queries.data_ptr(), out.data_ptr(), p, c, q,
        torch.cuda.current_stream().cuda_stream,
    )
    native.check(err, "online_lookup_i64")
    counter.add()


def gather_rows(
    values: torch.Tensor,
    creation_ts: torch.Tensor,
    part: torch.Tensor,
    slot: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Resident gather: (part, slot) (B,) coords -> feature rows (B, D) f32
    + creation_ts (B,) int64.  Misses should be clamped to slot 0 by the
    caller and masked after; the creation_ts feeds the TTL check so expiry
    never needs the host timestamp mirror."""
    part, slot = part.long(), slot.long()
    return values[part, slot], creation_ts[part, slot]


def route_and_lookup(
    keys: np.ndarray,
    values: np.ndarray,
    ids: np.ndarray,
    *,
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """Flat GET: ids (B,) int64 against a table of int64 keys (P, C) (-1
    empty) and float32 values (P, C, D), looked up and gathered on
    ``device``.

    Returns (values (B, D) float32, zeros where missing; found (B,) bool),
    in batch order."""
    ids = np.asarray(ids, np.int64)
    if len(ids) == 0:
        return np.zeros((0, values.shape[-1]), np.float32), np.zeros((0,), bool)
    dev = resolve_device(device)
    up = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)
    routed, part, pos = route_queries_i64(keys.shape[0], ids)
    slots = lookup(up(keys, np.int64), up(routed, np.int64))
    t_part = up(part, np.int64)
    got = slots[t_part, up(pos, np.int64)].long()
    found = got >= 0
    rows = up(values, np.float32)[t_part, got.clamp_min(0)]
    out = torch.where(found[:, None], rows, torch.zeros((), device=dev))
    return out.cpu().numpy(), found.cpu().numpy()
