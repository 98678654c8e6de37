"""Shared neural-net layers: norms, rotary embeddings, MLP variants, inits,
and the token embedding lookup.

The JAX package's ``models/layers.py`` on tensors.  Parameters live in
``ParamModule``s, which index like the JAX package's parameter dicts
(``p["w_up"]``, ``"ffn" in p``), so the functions below read as the JAX
ones do.  ``reduce_boundary`` is a plain cast here: its optimization barrier
exists for XLA's tensor-parallel all-reduce and has no counterpart on one
device.  Parameters are created frozen, as serving wants them;
``model.requires_grad_(True)`` makes every ``ParamModule``'s parameters
trainable (the train step does so), and ``requires_grad_(False)`` freezes
them again.

Under a mesh (``models/pspec.py``) the parameters are DTensors: ``rope``
places its frequency table, ``mlp_apply`` pins the hidden's F dim to
``model`` (the JAX package's anchor), and ``embedding`` looks tokens up in
a vocab-sharded table itself (see there).
"""

from __future__ import annotations

import math
from typing import Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.core.monitoring import span
from repro_torch.models.pspec import BATCH, constrain, current_mesh, placed

__all__ = [
    "MLP",
    "ParamModule",
    "apply_rope",
    "dense_init",
    "embedding",
    "layer_norm",
    "mlp_apply",
    "mlp_init",
    "reduce_boundary",
    "rms_norm",
    "rope",
    "torch_dtype",
]


def torch_dtype(name: str) -> torch.dtype:
    """A config's dtype name ("bfloat16", "float32", ...) as a torch dtype."""
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


class ParamModule(nn.Module):
    """Named tensors held as parameters, indexable by name like the JAX
    package's parameter dicts; child modules index too.  They start frozen
    (``requires_grad=False``); ``requires_grad_(True)`` on the module or any
    parent makes them trainable."""

    def __init__(self, tensors: Mapping[str, torch.Tensor] = ()) -> None:
        super().__init__()
        for name, t in dict(tensors).items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def reduce_boundary(x: torch.Tensor,
                    dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The operand of a row-parallel matmul in a compact dtype: a cast."""
    return x.to(dtype)


def dense_init(gen: Optional[torch.Generator], shape, fan_in: Optional[int] = None,
               dtype: torch.dtype = torch.bfloat16,
               device: Optional[torch.device] = None) -> torch.Tensor:
    """normal * 1/sqrt(fan_in), drawn in float32 on ``gen``'s device, then
    cast.  With no generator the tensor is left uninitialised on ``device``
    (for weights that are loaded next)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    fan = fan_in if fan_in is not None else shape[0]
    scale = 1.0 / math.sqrt(max(fan, 1))
    x = torch.randn(shape, generator=gen, dtype=torch.float32, device=gen.device)
    return (x * scale).to(dtype)


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Every call a span ``norm``."""
    with span("norm"):
        x32 = x.float()
        var = (x32 * x32).mean(dim=-1, keepdim=True)
        out = x32 * torch.rsqrt(var + eps) * (1.0 + gamma.float())
        return out.to(x.dtype)


def layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    mu = x32.mean(dim=-1, keepdim=True)
    var = x32.var(dim=-1, keepdim=True, correction=0)
    out = (x32 - mu) * torch.rsqrt(var + eps)
    out = out * gamma.float() + beta.float()
    return out.to(x.dtype)


# -- rotary position embeddings ------------------------------------------------
def rope(positions: torch.Tensor, dim: int,
         theta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """positions (...,) -> (cos, sin) of shape (..., dim//2), float32."""
    freqs = placed(torch.exp(
        -math.log(theta)
        * torch.arange(0, dim, 2, dtype=torch.float32, device=positions.device) / dim
    ))
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D) with cos/sin (..., S, D//2) — rotate-half convention."""
    d2 = x.shape[-1] // 2
    x1, x2 = x[..., :d2].float(), x[..., d2:].float()
    c = cos[..., None, :]  # broadcast over heads
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# -- MLPs ---------------------------------------------------------------------
def mlp_init(gen: Optional[torch.Generator], d_model: int, d_ff: int, variant: str,
             dtype: torch.dtype = torch.bfloat16,
             device: Optional[torch.device] = None) -> dict:
    init = lambda shape: (  # noqa: E731
        dense_init(gen, shape, dtype=dtype, device=device))
    if variant in ("swiglu", "geglu"):
        return {
            "w_gate": init((d_model, d_ff)),
            "w_up": init((d_model, d_ff)),
            "w_down": init((d_ff, d_model)),
        }
    return {"w_up": init((d_model, d_ff)), "w_down": init((d_ff, d_model))}


def mlp_apply(params, x: torch.Tensor, variant: str) -> torch.Tensor:
    if variant in ("swiglu", "geglu"):
        g = x @ params["w_gate"]
        g = F.silu(g) if variant == "swiglu" else F.gelu(g, approximate="tanh")
        h = g * (x @ params["w_up"])
    else:
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    # pin the hidden's F dim to the TP axis (the JAX package's anchor)
    h = constrain(h, *((BATCH,) + (None,) * (h.ndim - 2) + ("model",)))
    return reduce_boundary(h, x.dtype) @ params["w_down"]


class MLP(ParamModule):
    """One dense FFN: ``w_gate``/``w_up``/``w_down`` (SwiGLU, GeGLU) or
    ``w_up``/``w_down`` (GELU), in JAX's (in, out) layout."""

    def __init__(self, gen, d_model: int, d_ff: int, variant: str, *,
                 dtype: torch.dtype, device: Optional[torch.device] = None) -> None:
        super().__init__(mlp_init(gen, d_model, d_ff, variant, dtype, device))


# -- token embedding -------------------------------------------------------------
def embedding(tokens: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The rows of ``weight`` (V, D) at ``tokens``: ``F.embedding``.

    Under a mesh, with ``weight`` a DTensor, each rank looks its tokens up
    in its own vocab rows (the table gathered over its FSDP dim first),
    zeroes the tokens outside them, and returns the sum over the vocab's
    mesh dims pending (a ``Partial`` DTensor, placed like ``tokens`` on the
    other dims) for the caller's ``constrain`` to resolve.  DTensor's own
    vocab-sharded lookup (``MaskPartial``) fails on batch-sharded ids
    (torch 2.13).  A vocab dim of mesh size 1 is not sharded,
    so on a 1x1 mesh this is ``F.embedding`` of the whole table."""
    mesh = current_mesh()
    if mesh is None:
        return F.embedding(tokens, weight)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    tokens = placed(tokens)
    vocab = [i for i, p in enumerate(weight.placements)
             if p == Shard(0) and mesh.size(i) > 1]
    w = weight.redistribute(mesh, [Shard(0) if i in vocab else Replicate()
                                   for i in range(mesh.ndim)])
    tok_pl = [Replicate() if i in vocab else p for i, p in enumerate(tokens.placements)]
    tokens = tokens.redistribute(mesh, tok_pl)
    # the local weight's gradient sums over the ranks that hold other tokens
    grad_pl = [Shard(0) if i in vocab else Replicate() if p == Replicate()
               else Partial() for i, p in enumerate(tok_pl)]
    w_loc, tok = w.to_local(grad_placements=grad_pl), tokens.to_local()
    if not vocab:
        out = F.embedding(tok, w_loc)
    else:
        block = 0
        for i in vocab:  # the rank's vocab block, outer mesh dim first
            block = block * mesh.size(i) + mesh.get_local_rank(i)
        lo, rows = block * w_loc.shape[0], w_loc.shape[0]
        inside = (tok >= lo) & (tok < lo + rows)
        out = F.embedding(torch.where(inside, tok - lo, 0), w_loc)
        out = torch.where(inside[..., None], out, 0.0)
    return DTensor.from_local(out, mesh, [Partial() if i in vocab else p
                                          for i, p in enumerate(tok_pl)],
                              run_check=False)
