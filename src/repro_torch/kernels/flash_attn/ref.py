"""Plain PyTorch causal GQA attention: the flash kernel's ground truth.

Mirrors the JAX package's ``attention_ref``: query heads grouped onto their
kv head, float32 scores scaled by 1/sqrt(D), masked with -1e30 where the key
lies after the query, softmax, float32 output.
"""

from __future__ import annotations

import math

import torch

__all__ = ["attention_ref"]


def attention_ref(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, KV, D)
    v: torch.Tensor,  # (B, T, KV, D)
    *,
    causal: bool = True,
) -> torch.Tensor:
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    g = h // kv
    qg = q.reshape(b, s, kv, g, d).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / math.sqrt(d)
    if causal:
        mask = torch.arange(t, device=q.device)[None, :] <= torch.arange(s, device=q.device)[:, None]
        scores = scores.masked_fill(~mask, -1e30)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return out.reshape(b, s, h, d)
