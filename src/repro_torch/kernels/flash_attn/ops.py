"""Causal GQA flash attention in the model's layout, and its traffic model.

``flash_attention(q, k, v)`` takes (B, S, H, D) x (B, T, KV, D) and returns
(B, S, H, D) in q's dtype.  A CUDA tensor launches one of two kernels, chosen
by ``route``: bf16 at D 64, 112, 128 or 256 runs on the tensor cores
(``csrc/flash_attn_tc.cu``, wgmma on TMA-fed tiles, D=112 padded to 128 by
TMA's zero fill, P rounded to bf16 before P.V as the TPU kernel's
DEFAULT-precision dot does); float32 at every head dim, and bf16 at D 16 or
32, on the CUDA cores (``csrc/flash_attn.cu``, exact float32).  A CUDA
tensor at another head dim raises.  Both read kv head h // (H / KV) for
query head h in place and mask ragged S and T themselves: no GQA expansion,
no transpose, no padding copy.  A CPU tensor runs the plain version in
``ref.py``.

``flash_attention`` is differentiable (``FlashAttention``, a
``torch.autograd.Function``).  When a gradient is wanted the forward also
writes each query row's log-sum-exp (float32 (B, H, S)), and the backward
launches the backward kernel of the forward's route:
``csrc/flash_attn_bwd_tc.cu`` (wgmma) or ``csrc/flash_attn_bwd.cu`` (CUDA
cores, exact float32).  Both rebuild P from the log-sum-exp tile by tile,
sum delta = rowsum(P * dP) in float32 in a pass of their own (from the
forward's output, rounded, delta would swamp dP - delta wherever a row's
attention is sharp) and sum each GQA group's dK and dV in a fixed order,
so two calls give the same bits.  A CUDA tensor never reaches the plain
version; a CPU tensor runs ``ref.attention_bwd_lse_ref``, the plain version
of the kernels' contract.  The TPU package has no backward kernel to port
(XLA differentiates its einsum path).  ``flash_bytes`` is the JAX
package's analytic HBM-traffic model, verbatim.

On a mesh q, k and v are DTensors (batch over the data axes, heads over
``model``, by ``wq``/``wk``/``wv``'s placements): ``flash_attention`` runs on
each rank's local shards (``pspec.local_call``), the kernel seeing plain
tensors of the rank's batch rows and heads.  The sequence dims are gathered
first if sharded, and so are q's heads where k's and v's are not (MQA on a
``model`` axis wider than the KV heads): a rank's q heads must map onto
its own KV heads.  The ctypes entry points take ``data_ptr()`` and raise
if a DTensor reaches them.

The forward and the backward are each one dispatcher op
(``torch.ops.repro_torch.flash_fwd`` and ``flash_bwd``, custom ops around
``_forward`` and ``_backward``), so a meta tensor, as the dry-run gives
them, takes their fake implementations (the kernels' output shapes and
dtypes, never the ctypes entry), and ``FlopCounterMode`` (and the
dry-run's recorder) counts them at torch's own SDPA formulas: the forward
counts the two products an ``xla`` step's einsums count, the backward
five (the scores recomputed, then dV, dP, dQ and dK) where the autograd
of the ``xla`` einsums counts four.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import (
    register_flop_formula,
    sdpa_backward_flop_count,
    sdpa_flop_count,
)

from repro_torch.kernels import native
from repro_torch.kernels.flash_attn.ref import (
    attention_bwd_lse_ref,
    attention_lse_ref,
    attention_ref,
)

__all__ = ["BWD_ENTRIES", "ENTRIES", "HEAD_DIMS", "TC_HEAD_DIMS", "FlashAttention",
           "bwd_counter", "bwd_tc_counter", "counter", "flash_attention", "flash_bytes", "route",
           "tc_counter"]

#: head dims the kernels are built for (phi3/qwen 128, gemma 256, zamba2 112,
#: small checks)
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
#: head dims of the tensor-core route (bf16 only)
TC_HEAD_DIMS = (64, 112, 128, 256)
#: C entry of each route, forward and backward
ENTRIES = {"wgmma": "flash_attn_fwd_tc", "cuda_cores": "flash_attn_fwd"}
BWD_ENTRIES = {"wgmma": "flash_attn_bwd_tc", "cuda_cores": "flash_attn_bwd"}
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the JAX wrapper's default block: its non-causal path refuses a ragged T
_JAX_BLOCK = 512

#: every flash launch, either route
counter = native.LaunchCounter("flash_attn")
#: the tensor-core route's launches
tc_counter = native.LaunchCounter("flash_attn_wgmma")
#: every backward launch, either route, and the tensor-core route's
bwd_counter = native.LaunchCounter("flash_attn_bwd")
bwd_tc_counter = native.LaunchCounter("flash_attn_bwd_wgmma")
# the backward's per-row (log-sum-exp, delta) pairs are padded to this many rows
_STAT_ROWS = 128


def route(dtype: torch.dtype, d: int) -> str:
    """The kernels a CUDA call with this dtype and head dim launches,
    forward and backward."""
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
    tensors lie: CUDA launches the kernel, CPU runs the plain version, meta
    gives the output's shape (the custom ops' fake implementations).
    ``causal=False`` is refused where the JAX wrapper refuses it (a T that
    its blocks would pad), so both packages take the same calls.
    Differentiable in q, k and v (``FlashAttention``).  DTensors run on
    their local shards (see the module docstring)."""
    from torch.distributed.tensor import DTensor

    if isinstance(q, DTensor) or isinstance(k, DTensor) or isinstance(v, DTensor):
        return _flash_on_mesh(q, k, v, causal)
    _check_args(q, k, v)
    t = k.shape[1]
    bk = min(_JAX_BLOCK, _round_up(t, 8))
    if not causal and _round_up(t, bk) != t:
        raise NotImplementedError("non-causal padding path unused")
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"flash_attention runs on cuda or cpu (or meta: shapes only), "
                         f"not {q.device}")
    grad = torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)
    return FlashAttention.apply(q, k, v, causal, grad)


def _flash_on_mesh(q, k, v, causal: bool):
    """``flash_attention`` over DTensors: each rank's batch rows and heads."""
    from torch.distributed.tensor import DTensor

    from repro_torch.models.pspec import head_placements, local_call

    if not (isinstance(q, DTensor) and isinstance(k, DTensor) and isinstance(v, DTensor)):
        raise TypeError("flash_attention takes q, k and v all DTensors or all plain tensors")
    q_pl, kv_pl = head_placements(q, k)
    return local_call(
        lambda a, b, c: flash_attention(a.contiguous(), b.contiguous(), c.contiguous(),
                                        causal=causal),
        (q, k, v), (q_pl, kv_pl, kv_pl), q_pl)


class FlashAttention(torch.autograd.Function):
    """Forward: ``_forward`` (the kernel on CUDA, the plain version on the
    CPU), writing the log-sum-exp too when a gradient is wanted (``grad``;
    by default, when an input needs one).  Backward: ``_backward`` from q,
    k, v and the log-sum-exp.  ``flash_attention`` checks the arguments
    first; called directly (as ``gradcheck`` does, in float64 on the CPU)
    it checks none."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, grad: bool | None = None):
        ctx.causal = causal
        if grad is None:
            grad = any(ctx.needs_input_grad[:3])
        out, lse = torch.ops.repro_torch.flash_fwd(q, k, v, causal, grad)
        if grad:
            ctx.save_for_backward(q, k, v, lse)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = torch.ops.repro_torch.flash_bwd(q, k, v, lse, do.to(q.dtype).contiguous(),
                                                     ctx.causal)
        return dq, dk, dv, None, None


@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=())
def _flash_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
               grad: bool) -> tuple[torch.Tensor, torch.Tensor]:
    """``_forward`` as a dispatcher op: (out, the log-sum-exp, or an empty
    float32 tensor unless ``grad``)."""
    out, lse = _forward(q, k, v, causal, grad)
    return out, lse if lse is not None else q.new_empty((0,), dtype=torch.float32)


@_flash_fwd.register_fake
def _(q, k, v, causal, grad):
    b, s, h, _ = q.shape
    return torch.empty_like(q), q.new_empty((b, h, s) if grad else (0,), dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_bwd", mutates_args=())
def _flash_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse: torch.Tensor,
               do: torch.Tensor, causal: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``_backward`` as a dispatcher op: (dq, dk, dv)."""
    return tuple(_backward(q, k, v, lse, do, causal))


@_flash_bwd.register_fake
def _(q, k, v, lse, do, causal):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _sdpa_shapes(q_shape, k_shape) -> tuple:
    """(q, k, v) in SDPA's (B, H, S, D) layout, k and v at q's heads."""
    b, s, h, d = q_shape
    t = k_shape[1]
    return (b, h, s, d), (b, h, t, d), (b, h, t, d)


@register_flop_formula(torch.ops.repro_torch.flash_fwd)
def _(q_shape, k_shape, v_shape, causal, grad, out_shape=None, **kw) -> int:
    return sdpa_flop_count(*_sdpa_shapes(q_shape, k_shape))


@register_flop_formula(torch.ops.repro_torch.flash_bwd)
def _(q_shape, k_shape, v_shape, lse_shape, do_shape, causal, out_shape=None, **kw) -> int:
    qs, ks, vs = _sdpa_shapes(q_shape, k_shape)
    return sdpa_backward_flop_count(qs, qs, ks, vs)


def _check_launch(q: torch.Tensor, *tensors: torch.Tensor) -> None:
    from torch.distributed.tensor import DTensor

    if any(isinstance(x, DTensor) for x in (q, *tensors)):
        raise TypeError("a DTensor reached the flash kernel's entry point: "
                        "flash_attention runs DTensors on their local shards")
    b, s, h, _ = q.shape
    if s > 65535 * 64 or b * h >= 2**31:
        raise ValueError(f"flash_attention grid too large for B*H={b * h}, S={s}")
    for x in (q, *tensors):
        if x.data_ptr() % 16:
            raise ValueError("flash_attention takes 16-byte aligned q, k, v")


def _forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
             grad: bool = False) -> tuple[torch.Tensor, torch.Tensor | None]:
    """(out in q's dtype, lse float32 (B, H, S) when ``grad``, else None)."""
    if q.device.type == "cpu":
        if grad:
            out, lse = attention_lse_ref(q, k, v, causal=causal)
            return out.to(q.dtype), lse
        return attention_ref(q, k, v, causal=causal).to(q.dtype), None
    b, s, h, d = q.shape
    t = k.shape[1]
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device) if grad else None
    if b * s * h == 0:  # nothing to launch, nothing to count
        return torch.empty_like(q), lse
    _check_launch(q, k, v)
    path = route(q.dtype, d)
    entry = getattr(native.library(), ENTRIES[path])
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            b, s, t, h, k.shape[2], d, _DTYPES[q.dtype], int(causal),
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            stream,
        )
    native.check(err, ENTRIES[path])
    counter.add()
    if path == "wgmma":
        tc_counter.add()
    return out, lse


def _backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lse: torch.Tensor,
              do: torch.Tensor, causal: bool):
    """(dq, dk, dv) in the inputs' dtype from the forward's log-sum-exp: the
    plain version for a CPU tensor, else the backward kernels of ``route``
    (one C call: the delta, dK/dV and dQ passes, and the fixed-order GQA
    sum), or a raise."""
    if q.device.type == "cpu":
        return attention_bwd_lse_ref(q, k, v, lse, do, causal=causal)
    b, s, h, d = q.shape
    t, kv = k.shape[1], k.shape[2]
    if b * s * h == 0:
        return torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v)
    _check_launch(q, k, v, do)
    path = route(q.dtype, d)
    entry = getattr(native.library(), BWD_ENTRIES[path])
    with torch.cuda.device(q.device):
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        # (log-sum-exp, delta) per query row, padded; per-query-head float32
        # dK and dV, summed over each group afterwards (none when H == KV)
        stats = torch.empty((b * h, _round_up(s, _STAT_ROWS), 2), dtype=torch.float32,
                            device=q.device)
        part = (torch.empty((2, b, t, h, d), dtype=torch.float32, device=q.device)
                if h != kv else None)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lse.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), stats.data_ptr(),
            None if part is None else part.data_ptr(),
            b, s, t, h, kv, d, _DTYPES[q.dtype], int(causal),
            q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1), k.stride(2),
            stream,
        )
    native.check(err, BWD_ENTRIES[path])
    bwd_counter.add()
    if path == "wgmma":
        bwd_tc_counter.add()
    return dq, dk, dv


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
