"""Roofline analysis of a dry-run record: the JAX package's
``launch/roofline.py`` for the H100.

Terms per (arch x shape x mesh), in seconds, from one device's share of the
step as the dry-run records it (``launch/trace_tools.py``: every op each
rank runs on its local shards, and the operands of every collective):

  compute    = flops_per_device / PEAK_FLOPS
  memory     = bytes_per_device / HBM_BW
  collective = collective_bytes_per_device / LINK_BW

``collective_bytes`` sums the operand bytes of the collectives the record
holds, by kind: shapes there are local (per-device) shapes, so the sum is
per-device traffic, as the JAX package's sum over the post-SPMD module is.

Hardware model (NVIDIA H100 SXM, its data sheet; dense rates, no
sparsity): 989e12 bf16 FLOP/s, 3.35e12 B/s HBM3, and 450e9 B/s per
direction of NVLink 4 (900 GB/s bidirectional) as the one link figure.
Like the reference, which prices every mesh axis at one ICI link figure,
this prices every axis at NVLink's: an axis wider than an 8-GPU node
crosses InfiniBand (50e9 B/s per 400 Gb/s port), which this model does
not price.

The JAX module's ``dus_overcount`` corrects XLA's accounting of a
dynamic-update-slice (counted as a whole-buffer read and write where XLA
updates in place); the record counts the bytes of each op's operands and
outputs as the port runs them, so it has no counterpart here.
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Optional

__all__ = ["COLLECTIVE_KINDS", "HW", "RooflineReport", "collective_bytes",
           "roofline_from_terms"]

HW = {
    "peak_flops": 989e12,   # bf16 dense per card (H100 SXM data sheet)
    "hbm_bw": 3.35e12,      # bytes/s per card, HBM3 (H100 SXM data sheet)
    "link_bw": 450e9,       # bytes/s per direction, NVLink 4 (H100 SXM data sheet)
}

#: a collective op's name (``_c10d_functional`` or ``c10d``) -> its kind, as
#: the JAX package names HLO collectives
COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce", "allreduce_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced":
        "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "all_to_all_single": "all-to-all", "alltoall_base_": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}


def collective_bytes(record) -> dict[str, int]:
    """Per-collective-kind operand bytes (per device) of a dry-run record
    (``trace_tools.Recorder``)."""
    out: dict[str, int] = defaultdict(int)
    for op in record.collectives:
        out[op["kind"]] += op["bytes"]
    return dict(out)


@dataclasses.dataclass
class RooflineReport:
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    coll_breakdown: dict[str, int]
    compute_s: float
    memory_s: float
    collective_s: float
    dominant: str
    model_flops: Optional[float] = None
    useful_ratio: Optional[float] = None
    bytes_raw_per_dev: Optional[float] = None   # the JAX field; no adjustment here

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


def roofline_from_terms(
    flops: float, byts: float, colls: dict[str, int], *,
    model_flops_global: Optional[float] = None,
    num_devices: Optional[int] = None,
) -> RooflineReport:
    cb = float(sum(colls.values()))
    compute_s = flops / HW["peak_flops"]
    memory_s = byts / HW["hbm_bw"]
    collective_s = cb / HW["link_bw"]
    dominant = max(
        [("compute", compute_s), ("memory", memory_s), ("collective", collective_s)],
        key=lambda kv: kv[1],
    )[0]

    model_flops = useful = None
    if model_flops_global is not None and num_devices:
        model_flops = model_flops_global / num_devices
        useful = model_flops / flops if flops else None

    return RooflineReport(
        flops, byts, cb, {k: int(v) for k, v in colls.items()},
        compute_s, memory_s, collective_s, dominant, model_flops, useful,
    )
