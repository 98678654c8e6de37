"""Loss functions: the JAX package's ``models/losses.py`` on tensors.

The JAX cross-entropy picks each label's logit with a float32 one-hot of
(..., V) (a sum that GSPMD can keep vocab-sharded).  On one device that
one-hot is pure cost: 8.4 GB at gemma-2b's vocab and 4 x 2,048 tokens.  Here
the label's logit is a ``gather``, which is exactly the one-hot's sum (every
other term of it is ``0 * x``), and the log-sum-exp is taken in float32 as
in JAX.  The per-position negative log-likelihood is a
``torch.autograd.Function`` that keeps the logits as given (bfloat16 at full
width) for its backward and rebuilds the float32 softmax there, so the
float32 copy of the logits is freed as soon as the loss is formed.

Under a mesh the logits are a DTensor, sharded over the batch axes and, on
the vocab dim, over ``model`` (``lm.forward``'s constraint).  ``token_nll``
then computes each row's log-sum-exp and its label's logit from the local
vocab shards with two all-reduces over the vocab's mesh dim (max, then the
sum of exp and the label's logit), so no rank ever holds a row of the full
vocab: the option the JAX package's one-hot sum leaves to GSPMD.  The
backward needs no communication: softmax minus the one-hot, on each shard,
from the saved log-sum-exp.  Where the vocab dim is not sharded (a mesh
dim of size 1) each rank runs the one-device ``_TokenNLL`` on its rows.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["next_token_loss", "softmax_cross_entropy", "token_nll"]


class _TokenNLL(torch.autograd.Function):
    """nll = logsumexp(l32) - l32[label] per position, in float32."""

    @staticmethod
    def forward(ctx, logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        l32 = logits.float()
        lse = torch.logsumexp(l32, dim=-1)
        nll = lse - l32.gather(-1, labels[..., None]).squeeze(-1)
        ctx.save_for_backward(logits, labels, lse)
        return nll

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        logits, labels, lse = ctx.saved_tensors
        # d nll / d logits = softmax(l32) - onehot(label)
        grad = torch.exp(logits.float() - lse[..., None])
        idx = labels[..., None]
        grad.scatter_(-1, idx, grad.gather(-1, idx) - 1.0)
        grad.mul_(g[..., None])
        return grad.to(logits.dtype), None


class _ShardedTokenNLL(torch.autograd.Function):
    """``_TokenNLL`` on a vocab shard [lo, lo + V_loc) of the logits: the
    log-sum-exp and the label's logit summed over ``group``."""

    @staticmethod
    def forward(ctx, logits: torch.Tensor, labels: torch.Tensor, lo: int, group) -> torch.Tensor:
        import torch.distributed as dist

        l32 = logits.float()
        m = l32.amax(dim=-1)
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=group)
        local = labels - lo
        inside = (local >= 0) & (local < l32.shape[-1])
        idx = torch.where(inside, local, 0)[..., None]
        picked = torch.where(inside, l32.gather(-1, idx).squeeze(-1), 0.0)
        sums = torch.stack([torch.exp(l32 - m[..., None]).sum(dim=-1), picked])
        dist.all_reduce(sums, group=group)
        lse = m + torch.log(sums[0])
        ctx.save_for_backward(logits, idx, inside, lse)
        return lse - sums[1]

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        logits, idx, inside, lse = ctx.saved_tensors
        grad = torch.exp(logits.float() - lse[..., None])
        grad.scatter_add_(-1, idx, -inside.float()[..., None])
        grad.mul_(g[..., None])
        return grad.to(logits.dtype), None, None, None


def _sharded_token_nll(logits, labels: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.models.pspec import placed

    mesh = logits.device_mesh
    last = logits.ndim - 1
    if any(p.is_partial() for p in logits.placements):
        logits = logits.redistribute(mesh, [Replicate() if p.is_partial() else p
                                            for p in logits.placements])
    vocab = [i for i, p in enumerate(logits.placements) if p == Shard(last) and mesh.size(i) > 1]
    rows = [Replicate() if p == Shard(last) else p for p in logits.placements]
    labels = placed(labels).redistribute(mesh, rows)
    l_loc, y_loc = logits.to_local(), labels.to_local()
    if not vocab:
        nll = _TokenNLL.apply(l_loc, y_loc)
    elif len(vocab) == 1:
        (i,) = vocab
        nll = _ShardedTokenNLL.apply(l_loc, y_loc, mesh.get_local_rank(i) * l_loc.shape[-1],
                                     mesh.get_group(i))
    else:
        raise NotImplementedError(f"logits with the vocab over {len(vocab)} mesh dims")
    return DTensor.from_local(nll, mesh, rows, run_check=False)


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (..., V) any float dtype; labels (...) integer.  Per-position
    negative log-likelihood, float32."""
    from torch.distributed.tensor import DTensor

    if isinstance(logits, DTensor):
        return _sharded_token_nll(logits, labels.long())
    return _TokenNLL.apply(logits, labels.long())


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """logits (..., V) any float dtype; labels (...) integer.  Mean over
    masked positions, float32."""
    nll = token_nll(logits, labels)
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def next_token_loss(logits: torch.Tensor, tokens: torch.Tensor, *,
                    shift: int = 1) -> torch.Tensor:
    """Causal LM loss: logits[:, :-shift] predict tokens[:, shift:]."""
    return softmax_cross_entropy(logits[:, :-shift], tokens[:, shift:])
