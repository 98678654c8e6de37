"""Assigned input shapes and per-arch applicability: a copy of the JAX
package's ``configs/shapes.py`` (the port imports nothing of it).

Four shape cells per architecture:
  train_4k    — train_step,  seq 4096,    global batch 256
  prefill_32k — prefill,     seq 32768,   global batch 32
  decode_32k  — serve_step,  1 new token against a 32768 KV/state, batch 128
  long_500k   — serve_step,  1 new token against 524288 context, batch 1
                (sub-quadratic/compressed-state archs only)
"""

from __future__ import annotations

import dataclasses

__all__ = ["ShapeSpec", "SHAPES", "cells_for", "LONG_CTX_ARCHS", "ALL_ARCHS"]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524_288, 1),
}

ALL_ARCHS = (
    "deepseek-v2-lite-16b",
    "deepseek-v3-671b",
    "phi3-medium-14b",
    "gemma-2b",
    "qwen1.5-4b",
    "gemma3-1b",
    "zamba2-7b",
    "pixtral-12b",
    "whisper-tiny",
    "mamba2-2.7b",
)

#: archs whose decode state stays sub-quadratic/bounded at 500k context
#: (SSM / hybrid / mostly-local sliding window).  Everything else SKIPs
#: long_500k — see DESIGN.md §Shape-cell skips.
LONG_CTX_ARCHS = frozenset({"mamba2-2.7b", "zamba2-7b", "gemma3-1b"})


def cells_for(arch: str) -> list[tuple[str, str]]:
    """(arch, shape) cells to run; 40 total across the pool, with long_500k
    marked SKIP for pure full-attention archs."""
    out = []
    for shape in SHAPES:
        if shape == "long_500k" and arch not in LONG_CTX_ARCHS:
            continue
        out.append((arch, shape))
    return out
