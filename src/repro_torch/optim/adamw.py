"""AdamW with optional block-wise 8-bit moment state: the JAX package's
``optim/adamw.py`` on tensors.

Moments are float32, or block-128 int8 with a float32 scale per block (the
bitsandbytes recipe with deterministic round-half-to-even), which cuts m+v
from 8 to about 2.06 bytes a parameter.  The quantization is byte-identical
to the JAX package's, so checkpoints carry across and resume bit for bit.

The optimizer works over a dict of named tensors: ``init`` builds the state,
and ``update(grads, state, params)`` consumes its state and its params, as
the JAX driver's donated train state is consumed.  Leaf by leaf, float32
moments are updated in place (``mul_``/``add_`` in the JAX expression's
order, so the bits are those of ``b1*m + (1-b1)*g``) and the new weight is
written into the parameter before the next leaf; quantized moments are
dequantized, updated and requantized into the leaf's state entry.  It
returns ``params`` and ``state``, the same objects, updated; the grads are
left alone.  The peak is then the weights, the grads, the moments and one
leaf's float32 temporaries, not a second copy of the moments and weights.
On a mesh the parameters, their gradients and float32 moments are
DTensors of the same placements (the moments' may add a ``pod`` shard,
``sharding.opt_state_specs``), and the same in-place ops run on each
rank's shards; the global-norm clip sums every shard's squares; ``count``
stays a plain 0-d tensor, the same on every rank.
The update is the JAX one,
``upd = (m/bc1)/(sqrt(v/bc2)+eps) + wd·p`` and ``p <- (p32 - lr·upd)`` cast
back to p's dtype, with the global-norm clip in float32; it is not
``torch.optim.AdamW``, whose decay and eps sit elsewhere.  Leaves are
updated one at a time, so the float32 temporaries live for one leaf, not
for the whole model.  The JAX package's ``sequential_updates`` forces that
order on XLA's scheduler with an ``optimization_barrier`` chain; eager
PyTorch runs in program order, so neither the barrier nor the option has a
counterpart here.
"""

from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.nn.functional as F

from repro_torch.models.pspec import is_dtensor

__all__ = ["Optimizer", "adamw", "dequantize_q8", "quantize_q8"]

_BLOCK = 128


def quantize_q8(x: torch.Tensor) -> dict:
    """float -> {q: int8 (same shape as x), scale: float32 (..., ceil(last/128))}.
    Blocks run along the last dim (128 entries each, zero-padded tail); a 0-d
    x is one block of one entry.  A DTensor is quantized on its local
    shards (``_block_placements``); its scales come back with the last
    dim replicated, as the JAX package's ``opt_state_specs`` places them."""
    if is_dtensor(x):
        from torch.distributed.tensor import DTensor, Replicate

        mesh, pl = x.device_mesh, _block_placements(x)
        out = quantize_q8(x.redistribute(mesh, pl).to_local())
        whole_last = [Replicate() if _is_last_shard(p, x) else p for p in pl]
        return {"q": DTensor.from_local(out["q"], mesh, pl, run_check=False),
                "scale": DTensor.from_local(out["scale"], mesh, pl, run_check=False)
                .redistribute(mesh, whole_last)}
    x32 = x.float()
    if x32.dim() == 0:
        x32 = x32.reshape(1)
    last = x32.shape[-1]
    nb = -(-last // _BLOCK)
    blocks = F.pad(x32, (0, nb * _BLOCK - last)).reshape(*x32.shape[:-1], nb, _BLOCK)
    scale = blocks.abs().amax(dim=-1) / 127.0  # (..., nb)
    safe = torch.where(scale > 0, scale, 1.0)[..., None]
    q = torch.clamp(torch.round(blocks / safe), -127, 127).to(torch.int8)
    q = q.reshape(*x32.shape[:-1], nb * _BLOCK)[..., :last]
    return {"q": q.reshape(x.shape).contiguous(), "scale": scale}


def dequantize_q8(qs: dict, shape, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    q, scale = qs["q"], qs["scale"]
    if is_dtensor(q):
        from torch.distributed.tensor import DTensor

        mesh, pl = q.device_mesh, _block_placements(q)
        q_loc = q.redistribute(mesh, pl).to_local()
        out = dequantize_q8({"q": q_loc, "scale": scale.redistribute(mesh, pl).to_local()},
                            q_loc.shape, dtype)
        return DTensor.from_local(out, mesh, pl, run_check=False).reshape(shape)
    q32 = q.float()
    if q32.dim() == 0:
        q32 = q32.reshape(1)
    last = q32.shape[-1]
    nb = scale.shape[-1]
    blocks = F.pad(q32, (0, nb * _BLOCK - last)).reshape(*q32.shape[:-1], nb, _BLOCK)
    out = (blocks * scale[..., None]).reshape(*q32.shape[:-1], nb * _BLOCK)
    return out[..., :last].reshape(shape).to(dtype)


def _is_last_shard(p, x) -> bool:
    from torch.distributed.tensor import Shard

    return x.ndim > 0 and p == Shard(x.ndim - 1)


def _block_placements(x) -> list:
    """``x``'s placements for blocking on local shards: as they are, but
    the last dim gathered where its shards would split a 128-entry block
    (the blocks, and so the bits, are then the unsharded ones).  DTensor
    is not asked to pad or view: some torch releases place ``F.pad`` of a
    DTensor wrongly on a mesh of more than one dim."""
    from torch.distributed.tensor import Replicate

    ranks = math.prod(x.device_mesh.size(i) for i, p in enumerate(x.placements)
                      if _is_last_shard(p, x))
    if ranks > 1 and (x.shape[-1] // ranks) % _BLOCK:
        return [Replicate() if _is_last_shard(p, x) else p for p in x.placements]
    return list(x.placements)


class Optimizer(NamedTuple):
    init: Callable[[dict], Any]
    update: Callable[[dict, Any, dict], tuple[dict, Any]]


def adamw(
    lr: float | Callable[[torch.Tensor], torch.Tensor] = 1e-3,
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    grad_clip: Optional[float] = 1.0,
    quantize_moments: bool = False,
) -> Optimizer:
    """AdamW over a dict of named tensors.  ``lr`` is a float or a schedule
    of the step count (``optim/schedules.py``)."""

    def init(params: dict) -> dict:
        def zeros_like_moment(p):
            # a DTensor parameter's moments are DTensors of its placements
            z = torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format)
            return quantize_q8(z) if quantize_moments else z

        some = next(iter(params.values()))
        return {
            "count": torch.zeros((), dtype=torch.int32, device=some.device),
            "m": {n: zeros_like_moment(p) for n, p in params.items()},
            "v": {n: zeros_like_moment(p) for n, p in params.items()},
        }

    @torch.no_grad()
    def update(grads: dict, state: dict, params: dict) -> tuple[dict, dict]:
        count = state["count"] + 1
        scale = None
        if grad_clip is not None:
            gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))
            scale = torch.clamp(grad_clip / torch.clamp(gnorm, min=1e-9), max=1.0)

        step_size = lr(count) if callable(lr) else lr
        bc1 = 1.0 - b1 ** count.float()
        bc2 = 1.0 - b2 ** count.float()

        for name, g in grads.items():
            p = params[name]
            if scale is not None:
                g = g * scale.to(g.dtype)
            g32 = g.float()
            if quantize_moments:
                m = dequantize_q8(state["m"][name], p.shape)
                v = dequantize_q8(state["v"][name], p.shape)
            else:
                m, v = state["m"][name], state["v"][name]
            m.mul_(b1).add_((1 - b1) * g32)
            v.mul_(b2).add_(((1 - b2) * g32).mul_(g32))
            del g, g32
            # (m/bc1) / (sqrt(v/bc2) + eps) [+ wd·p], then p32 - lr·upd: the
            # same roundings, in place on one leaf-sized temporary at a time
            upd = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
            if weight_decay:
                upd.add_(weight_decay * p.float())
            p.copy_(p.float().sub_(upd.mul_(step_size)).to(p.dtype))
            del upd
            if quantize_moments:
                state["m"][name], state["v"][name] = quantize_q8(m), quantize_q8(v)
        state["count"] = count
        return params, state

    return Optimizer(init, update)
