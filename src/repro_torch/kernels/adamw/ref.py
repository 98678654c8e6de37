"""Plain PyTorch versions of the fused AdamW kernels (``csrc/adamw.cu``).

``adamw_update_ref`` is the kernel's per-element formula, written as the
kernel computes it: each constant a float32 value (the double ``1 - b1``
cast to float, as PyTorch casts a Python scalar), each operation rounded to
float32 on its own, the clipped gradient rounded to the gradient's dtype and
the new weight to the weight's.  Given the same clip scale it gives the same
bits as the optimizer's leaf-by-leaf passes (``optim/adamw.py``).
"""

from __future__ import annotations

import torch

__all__ = ["adamw_sqnorm_ref", "adamw_update_ref"]


def _f32(x, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def adamw_update_ref(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor,
                     v: torch.Tensor, *, scale, bc1, bc2, step, b1: float, b2: float,
                     eps: float, weight_decay: float) -> None:
    """One leaf's update, in place on ``p`` and its float32 moments ``m``
    and ``v``.  ``scale`` (the clip's, or None), ``bc1``, ``bc2`` are 0-d
    float32 tensors, ``step`` one too or a float.  Per element:
    g = (g * scale) rounded to g's dtype; m = m*b1 + (1-b1)*g;
    v = v*b2 + ((1-b2)*g)*g; u = (m/bc1) / (sqrt(v/bc2) + eps) [+ wd*p];
    p = p - u*step rounded to p's dtype."""
    dev = p.device
    b1_, c1, b2_, c2 = (_f32(x, dev) for x in (b1, 1 - b1, b2, 1 - b2))
    if scale is not None:
        g = torch.mul(g, scale.to(g.dtype))
    g32 = g.float()
    m.copy_(torch.add(torch.mul(m, b1_), torch.mul(c1, g32)))
    v.copy_(torch.add(torch.mul(v, b2_), torch.mul(torch.mul(c2, g32), g32)))
    u = torch.div(torch.div(m, bc1),
                  torch.add(torch.sqrt(torch.div(v, bc2)), _f32(eps, dev)))
    p32 = p.float()
    if weight_decay:
        u = torch.add(u, torch.mul(_f32(weight_decay, dev), p32))
    p.copy_(torch.sub(p32, torch.mul(u, _f32(step, dev))).to(p.dtype))


def adamw_sqnorm_ref(grads: list[torch.Tensor]) -> torch.Tensor:
    """Σ g² over every element of ``grads``: each square rounded to float32,
    as ``square(g.float())`` is, summed in float64 and rounded once to a
    float32 0-d tensor."""
    total = torch.zeros((), dtype=torch.float64, device=grads[0].device)
    for g in grads:
        total = total + torch.sum(torch.square(g.float()), dtype=torch.float64)
    return total.float()
