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


def token_nll(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits (..., V) any float dtype; labels (...) integer.  Per-position
    negative log-likelihood, float32."""
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
