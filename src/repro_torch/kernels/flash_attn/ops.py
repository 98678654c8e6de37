"""Causal GQA flash attention in the model's layout, and its traffic model.

``flash_attention(q, k, v)`` takes (B, S, H, D) x (B, T, KV, D) and returns
(B, S, H, D) in q's dtype.  A CUDA tensor launches one of two kernels, chosen
by ``route``: bf16 at D 64, 128 or 256 runs on the tensor cores
(``csrc/flash_attn_tc.cu``, wgmma on TMA-fed tiles, P rounded to bf16 before
P.V as the TPU kernel's DEFAULT-precision dot does); float32, and bf16 at D
16, 32 or 112 (zamba2), on the CUDA cores (``csrc/flash_attn.cu``, exact
float32).  A CUDA tensor at another head dim raises.  Both
read kv head h // (H / KV) for query head h in place and mask ragged S and T
themselves: no GQA expansion, no transpose, no padding copy.  A CPU tensor
runs the plain version in ``ref.py``.

``flash_attention`` is differentiable (``FlashAttention``, a
``torch.autograd.Function``): the forward is the kernel (or the plain
version on the CPU), the backward ``ref.attention_bwd_ref``, plain PyTorch
by recompute on both devices, the gradient of the einsum path.  The TPU
package has no backward kernel to port.  ``flash_bytes`` is the JAX
package's analytic HBM-traffic model, verbatim.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import native
from repro_torch.kernels.flash_attn.ref import attention_bwd_ref, attention_ref

__all__ = ["ENTRIES", "HEAD_DIMS", "TC_HEAD_DIMS", "FlashAttention", "counter", "flash_attention",
           "flash_bytes", "route", "tc_counter"]

#: head dims the kernels are built for (phi3/qwen 128, gemma 256, zamba2 112,
#: small checks)
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
#: head dims of the tensor-core route (bf16 only)
TC_HEAD_DIMS = (64, 128, 256)
#: C entry of each route
ENTRIES = {"wgmma": "flash_attn_fwd_tc", "cuda_cores": "flash_attn_fwd"}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the JAX wrapper's default block: its non-causal path refuses a ragged T
_JAX_BLOCK = 512

#: every flash launch, either route
counter = native.LaunchCounter("flash_attn")
#: the tensor-core route's launches
tc_counter = native.LaunchCounter("flash_attn_wgmma")


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA call with this dtype and head dim launches."""
    return "wgmma" if dtype == torch.bfloat16 and d in TC_HEAD_DIMS else "cuda_cores"


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _check_args(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(
            f"flash_attention takes q (B, S, H, D) and k, v (B, T, KV, D), got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    b, _, h, d = q.shape
    kv = k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or kv == 0 or h % kv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not pair (H % KV == 0)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(
            f"flash_attention takes float32 or bfloat16 q, k, v of one dtype, got "
            f"{q.dtype}, {k.dtype}, {v.dtype}"
        )
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} is not one the kernel is built for: {HEAD_DIMS}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention takes contiguous q, k, v")
    if k.shape[1] == 0 and q.shape[1] > 0:
        raise ValueError("flash_attention needs at least one key")


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, T, KV, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
) -> torch.Tensor:
    """Attention of q over k, v (key t masked for query s where t > s when
    ``causal``), float32 inside, returned in q's dtype.  Runs where the
    tensors lie: CUDA launches the kernel, CPU runs the plain version.
    ``causal=False`` is refused where the JAX wrapper refuses it (a T that
    its blocks would pad), so both packages take the same calls.
    Differentiable in q, k and v (``FlashAttention``)."""
    _check_args(q, k, v)
    t = k.shape[1]
    bk = min(_JAX_BLOCK, _round_up(t, 8))
    if not causal and _round_up(t, bk) != t:
        raise NotImplementedError("non-causal padding path unused")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cuda or cpu, not {q.device}")
    return FlashAttention.apply(q, k, v, causal)


class FlashAttention(torch.autograd.Function):
    """Forward: ``_forward`` (the kernel on CUDA, the plain version on the
    CPU).  Backward: ``attention_bwd_ref`` from the saved inputs, on either
    device.  ``flash_attention`` checks the arguments first; called
    directly (as ``gradcheck`` does, in float64 on the CPU) it checks none."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        ctx.causal = causal
        ctx.save_for_backward(q, k, v)
        return _forward(q, k, v, causal)

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = attention_bwd_ref(q, k, v, do, causal=ctx.causal)
        return dq, dk, dv, None


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool) -> torch.Tensor:
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal).to(q.dtype)
    b, s, h, d = q.shape
    t = k.shape[1]
    if b * s * h == 0:  # nothing to launch, nothing to count
        return torch.empty_like(q)
    if s > 65535 * 64 or b * h >= 2**31:
        raise ValueError(f"flash_attention grid too large for B*H={b * h}, S={s}")
    for x in (q, k, v):
        if x.data_ptr() % 16:
            raise ValueError("flash_attention takes 16-byte aligned q, k, v")
    path = route(q.dtype, d)
    entry = getattr(native.library(), ENTRIES[path])
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b, s, t, h, k.shape[2], d, _DTYPES[q.dtype], int(causal),
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            stream,
        )
    native.check(err, ENTRIES[path])
    counter.add()
    if path == "wgmma":
        tc_counter.add()
    return out


def flash_bytes(b: int, s: int, t: int, h: int, kv: int, d: int,
                *, dtype_bytes: int = 2, block_k: int = 512) -> int:
    """Analytic HBM traffic of the flash forward: Q read once, K/V streamed
    once per q-block row of the grid, O written once.  This is the number
    the §Roofline 'with-flash' adjusted memory term substitutes for the
    measured XLA score traffic."""
    q_bytes = b * h * s * d * dtype_bytes
    o_bytes = q_bytes
    n_q_blocks = max(1, s // block_k)
    kv_bytes = 2 * b * kv * t * d * dtype_bytes * n_q_blocks
    return q_bytes + o_bytes + kv_bytes
