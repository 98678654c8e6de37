"""AdamW's fused update and the global norm's sum of squares
(``csrc/adamw.cu``).

  * ``sqnorm`` — Σ g² over a list of gradients (bf16 or float32), a float32
    0-d tensor on their device.  On the card each leaf's blocks write
    float64 partial sums and one more pass adds them in a fixed order: the
    same bits on every run, and no wait for the host.
  * ``update`` — AdamW's step on a list of leaves (weight, gradient and
    float32 moments), in place, one launch a leaf.  It reads each element of
    g, m, v and p once and writes m, v and p once, with the leaf-by-leaf
    path's roundings (``ref.adamw_update_ref``).

Both run on CUDA tensors only.  ``takes`` is the optimizer's
(``optim/adamw.py``) one test of which leaves come here: plain tensors on a
card.  A leaf it sends that the kernels cannot take (strided, or a dtype
outside ``DTYPES``) raises; it never falls back to the plain passes.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import native
from repro_torch.models.pspec import is_dtensor

__all__ = ["DTYPES", "counter", "sqnorm", "sqnorm_blocks", "sqnorm_counter", "takes",
           "update"]

# the kernels' dtype codes
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# csrc/adamw.cu: threads a block, elements a group, groups a thread takes
# at once in the sum; and the most blocks a leaf's sum has
THREADS, VEC, SUM_UNROLL = 256, 8, 4
MAX_SUM_BLOCKS = 1024

# one count per leaf launched
counter = native.LaunchCounter("adamw_update")
# one count per call of the C entry: a partial-sum kernel a leaf, one final
sqnorm_counter = native.LaunchCounter("adamw_sqnorm")


def sqnorm_blocks(n: int) -> int:
    """Blocks (and float64 partial sums) of a leaf of ``n`` elements."""
    return min(-(-n // (THREADS * VEC * SUM_UNROLL)), MAX_SUM_BLOCKS)


def takes(p, g, m, v) -> bool:
    """The leaf (weight, gradient, moments) is the kernels' by its
    structure: each a plain tensor (not a DTensor, not an int8 block dict)
    on a card.  Its dtypes, layout and shape are ``update``'s to check."""
    return all(isinstance(t, torch.Tensor) and not is_dtensor(t)
               and t.device.type == "cuda" for t in (p, g, m, v))


def _check_leaf(tensors, dtypes, what: str) -> None:
    for t, allowed in zip(tensors, dtypes):
        if t.dtype not in allowed:
            raise TypeError(f"{what}: {t.dtype} is not one of "
                            f"{sorted(map(str, allowed))}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: takes contiguous tensors")
        if t.device != tensors[0].device:
            raise ValueError(f"{what}: tensors on {tensors[0].device} and {t.device}")
        if t.shape != tensors[0].shape:
            raise ValueError(f"{what}: shapes {tuple(tensors[0].shape)} and "
                             f"{tuple(t.shape)}")


def _device(tensors: list, what: str) -> torch.device:
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{what}: takes tensors on one device")
    if dev.type != "cuda":
        raise ValueError(f"{what}: runs on cuda, not {dev}")
    return dev


def sqnorm(grads: list[torch.Tensor]) -> torch.Tensor:
    """Σ g² over every element of ``grads`` (bf16 or float32, contiguous,
    on one card): a float32 0-d tensor on that card.  Squares are rounded to
    float32 and summed in float64 (``ref.adamw_sqnorm_ref``)."""
    if not grads:
        raise ValueError("sqnorm takes at least one gradient")
    for g in grads:
        _check_leaf((g,), (DTYPES,), "sqnorm")
    dev = _device(grads, "sqnorm")
    blocks = [sqnorm_blocks(g.numel()) for g in grads]
    partials = torch.empty(max(sum(blocks), 1), dtype=torch.float64, device=dev)
    out = torch.empty((), dtype=torch.float32, device=dev)
    _launch_sqnorm(grads, blocks, partials, out)
    return out


def update(leaves: list[tuple], *, scale, bc1, bc2, step, b1: float, b2: float,
           eps: float, weight_decay: float) -> None:
    """AdamW's step on ``leaves``, each (p, g, m, v): p and g bf16 or
    float32, m and v float32, all contiguous, of one shape and on one card;
    p, m and v are updated in place.  ``scale`` (the clip's, or
    None), ``bc1``, ``bc2`` are 0-d float32 tensors on that device, ``step``
    one too or a float.  The arithmetic is ``ref.adamw_update_ref``'s."""
    if not leaves:
        return
    for leaf in leaves:
        _check_leaf(leaf, (DTYPES, DTYPES, (torch.float32,), (torch.float32,)),
                    "adamw update")
    dev = _device([leaf[0] for leaf in leaves], "adamw update")
    scalars = [scale, bc1, bc2] + ([step] if isinstance(step, torch.Tensor) else [])
    for s in scalars:
        if s is not None and (s.dtype != torch.float32 or s.dim() != 0
                              or s.device != dev):
            raise ValueError(f"adamw update: the step's scalars are 0-d float32 "
                             f"tensors on {dev}, got {s.dtype} {tuple(s.shape)} on "
                             f"{s.device}")
    _launch_update(leaves, scale, bc1, bc2, step, b1=b1, b2=b2, eps=eps,
                   weight_decay=weight_decay)


def _ptrs(tensors) -> ctypes.Array:
    return (ctypes.c_int64 * len(tensors))(*(t.data_ptr() for t in tensors))


def _ints(xs) -> ctypes.Array:
    return (ctypes.c_int32 * len(xs))(*xs)


def _launch_sqnorm(grads, blocks, partials, out) -> None:
    """Launch the sum on checked CUDA tensors on the current stream, and
    count the call."""
    with torch.cuda.device(out.device):
        err = native.library().adamw_sqnorm(
            _ptrs(grads), (ctypes.c_int64 * len(grads))(*(g.numel() for g in grads)),
            _ints([DTYPES[g.dtype] for g in grads]), _ints(blocks), len(grads),
            partials.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    native.check(err, "adamw_sqnorm")
    sqnorm_counter.add()


def _launch_update(leaves, scale, bc1, bc2, step, *, b1, b2, eps, weight_decay) -> None:
    """Launch one update a leaf on checked CUDA tensors on the current
    stream, and count each launch (an empty leaf launches nothing)."""
    p, g, m, v = (list(x) for x in zip(*leaves))
    constant = not isinstance(step, torch.Tensor)
    with torch.cuda.device(p[0].device):
        err = native.library().adamw_update(
            _ptrs(p), _ptrs(g), _ptrs(m), _ptrs(v),
            (ctypes.c_int64 * len(p))(*(t.numel() for t in p)),
            _ints([DTYPES[t.dtype] for t in p]), _ints([DTYPES[t.dtype] for t in g]),
            len(p),
            None if scale is None else scale.data_ptr(), bc1.data_ptr(), bc2.data_ptr(),
            None if constant else step.data_ptr(), float(step) if constant else 0.0,
            b1, 1 - b1, b2, 1 - b2, eps, weight_decay, int(bool(weight_decay)),
            torch.cuda.current_stream().cuda_stream)
    native.check(err, "adamw_update")
    for t in p:
        if t.numel():
            counter.add()
