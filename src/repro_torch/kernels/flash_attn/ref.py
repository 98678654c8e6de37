"""Plain PyTorch causal GQA attention: the flash kernels' ground truth,
forward and backward.

``attention_ref`` mirrors the JAX package's ``attention_ref``: query heads
grouped onto their kv head, float32 scores scaled by 1/sqrt(D), masked with
-1e30 where the key lies after the query, softmax, float32 output.
``attention_lse_ref`` also returns the log-sum-exp of each query row's
scaled, masked scores, which the forward kernels write for the backward.

``attention_bwd_lse_ref`` is the plain version of the backward kernels'
contract: from q, k, v, the forward's log-sum-exp and dO it rebuilds P =
exp(S/sqrt(D) - lse) and sums delta = rowsum(P * dP).  The CPU path runs
it.  ``attention_bwd_ref`` is the gradient of
``attention_ref`` by recompute, as autograd takes it through the einsum
(``xla``) path: the ground truth both are held against.  The TPU package
has no backward kernel (XLA differentiates its einsum path).  All take
float64 inputs in float64 (for ``gradcheck``), anything else in float32.
"""

from __future__ import annotations

import math

import torch

__all__ = ["attention_bwd_lse_ref", "attention_bwd_ref", "attention_lse_ref",
           "attention_ref"]


def _acc(*xs: torch.Tensor) -> torch.dtype:
    return torch.float64 if any(x.dtype == torch.float64 for x in xs) else torch.float32


def _scores(q: torch.Tensor, k: torch.Tensor,
            causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(qg (B, S, KV, G, D), scaled masked scores (B, KV, G, S, T)) in the
    accumulation dtype."""
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    acc = _acc(q, k)
    qg = q.reshape(b, s, kv, h // kv, d).to(acc)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.to(acc)) / math.sqrt(d)
    if causal:
        pos = torch.arange(max(s, t), device=q.device)
        mask = pos[None, :t] <= pos[:s, None]
        scores = scores.masked_fill(~mask, -1e30)
    return qg, scores


def _probs(q: torch.Tensor, k: torch.Tensor,
           causal: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """(qg (B, S, KV, G, D), P (B, KV, G, S, T)) in the accumulation dtype."""
    qg, scores = _scores(q, k, causal)
    return qg, torch.softmax(scores, dim=-1)


def attention_ref(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, KV, D)
    v: torch.Tensor,  # (B, T, KV, D)
    *,
    causal: bool = True,
) -> torch.Tensor:
    _, w = _probs(q, k, causal)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.to(w.dtype))
    return out.reshape(q.shape)


def attention_lse_ref(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, KV, D)
    v: torch.Tensor,  # (B, T, KV, D)
    *,
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(``attention_ref``'s output, lse (B, H, S)): lse is the log-sum-exp
    over keys of each query row's scaled, masked scores, m + log(l) in the
    flash kernels' terms; masked keys add exp(-1e30 - m) = 0."""
    b, s, h, _ = q.shape
    _, scores = _scores(q, k, causal)
    lse = torch.logsumexp(scores, dim=-1)  # (B, KV, G, S)
    out = torch.einsum("bkgst,btkd->bskgd", torch.exp(scores - lse[..., None]),
                       v.to(scores.dtype))
    return out.reshape(q.shape), lse.reshape(b, h, s)


def attention_bwd_ref(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, KV, D)
    v: torch.Tensor,  # (B, T, KV, D)
    do: torch.Tensor,  # (B, S, H, D): the gradient of the output
    *,
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``attention_ref`` at (q, k, v) for output gradient
    ``do``, each in its input's dtype.  With P = softmax(QKᵀ/√D):
    dV = Pᵀ·dO, dP = dO·Vᵀ, dS = P∘(dP − rowsum(P∘dP)), dQ = dS·K/√D,
    dK = dSᵀ·Q/√D; rowsum(P∘dP) is rowsum(dO∘O).  dK and dV sum over each
    GQA group onto its kv head."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qg, p = _probs(q, k, causal)
    dog = do.reshape(b, s, kv, h // kv, d).to(p.dtype)
    dv = torch.einsum("bkgst,bskgd->btkd", p, dog)
    dp = torch.einsum("bskgd,btkd->bkgst", dog, v.to(p.dtype))
    dp -= (p * dp).sum(-1, keepdim=True)
    ds = dp.mul_(p)
    scale = 1.0 / math.sqrt(d)
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.to(p.dtype)) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg) * scale
    return dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_bwd_lse_ref(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, KV, D)
    v: torch.Tensor,  # (B, T, KV, D)
    lse: torch.Tensor,  # (B, H, S) float32: the forward's log-sum-exp
    do: torch.Tensor,  # (B, S, H, D): the gradient of the output
    *,
    causal: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) by the backward kernels' contract, each in its input's
    dtype: P = exp(QKᵀ/√D − lse) from the saved log-sum-exp (no softmax
    again), dP = dO·Vᵀ, δ = rowsum(P∘dP), dV = Pᵀ·dO, dS = P∘(dP − δ),
    dQ = dS·K/√D, dK = dSᵀ·Q/√D, in float32 (float64 for float64 inputs).
    δ is summed from P and dP, not taken as rowsum(dO∘O): where a row's
    attention is sharp dP − δ is a small difference, and the error of an O
    rounded to bf16 (or of the forward's P rounded before P·V) swamps it.
    dK and dV sum over each GQA group onto its kv head."""
    b, s, h, d = q.shape
    kv = k.shape[2]
    qg, scores = _scores(q, k, causal)
    acc = scores.dtype
    p = torch.exp(scores - lse.to(acc).reshape(b, kv, h // kv, s)[..., None])
    dog = do.reshape(b, s, kv, h // kv, d).to(acc)
    dv = torch.einsum("bkgst,bskgd->btkd", p, dog)
    dp = torch.einsum("bskgd,btkd->bkgst", dog, v.to(acc))
    ds = (dp - (p * dp).sum(-1, keepdim=True)).mul_(p)
    scale = 1.0 / math.sqrt(d)
    dq = torch.einsum("bkgst,btkd->bskgd", ds, k.to(acc)) * scale
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg) * scale
    return dq.reshape(q.shape).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
