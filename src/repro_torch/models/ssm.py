"""Mamba2 blocks via the SSD (state-space duality) chunked algorithm
(arXiv:2405.21060).

The JAX package's ``models/ssm.py`` on tensors.  The chunked form is
matmul-dominated: intra-chunk terms are Q x Q attention-like einsums and the
inter-chunk state passing is a short loop over chunks (JAX's ``lax.scan``),
carried in float32 in chunk order.  The JAX package computes all of it as
XLA ops (no Pallas kernel), so here it is plain PyTorch; B/C groups repeat
over heads with ``repeat_interleave`` (``jnp.repeat``).

Shapes (per block):
  x_in (B, L, D) -> in_proj -> z (B,L,DI), xBC (B,L,DI+2GN), dt (B,L,H)
  conv1d width W over xBC (causal), silu
  SSD over x (B,L,H,P), A (H,), B/C (B,L,G,N), dt (B,L,H)
  gated RMSNorm, out_proj (DI, D)

The intra-chunk decay exp(cum_i - cum_j) is masked to the lower triangle
before ``exp``, as exp(where(tri, diff, -inf)).  Above the diagonal diff is
>= 0 and grows with the chunk: the JAX package's where(tri, exp(diff), 0)
overflows there once Σ dt·|A| over a chunk passes 88.7 (float32), and its
gradient is then 0 x inf = NaN, though the forward masks the inf away.
Masking first gives the same forward, bit for bit (exp(-inf) is 0 and the
kept entries are the same diff), and a gradient equal to JAX's wherever
JAX's is finite (``tests/test_torch_ssm.py``).  The other exponents,
total - cum, cum and total, are <= 0 and cannot overflow.

Decode keeps a conv ring (B, W-1, DI+2GN) and the SSM state (B, H, P, N) in
float32: O(1) memory per token.  ``mamba_decode`` updates both in the state
dict in place (JAX returns new arrays) and returns the same dict.  On a
mesh the step runs on local shards (``pspec.local_call``): the SSM state
sharded on its heads is advanced on each rank's heads, and the conv ring
sharded on its channels is gathered for the window (its channel shards do
not line up with the x/B/C split: mamba2-2.7b's 5,376 channels are 336 a
rank at ``model`` = 16), each rank writing its own channels back into its
shard.
"""


from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import ParamModule, dense_init, reduce_boundary, rms_norm
from repro_torch.models.pspec import (
    gather_over,
    is_dtensor,
    local_call,
    row_placements,
    seq_placements,
    shard_of,
    weight_grad_placements,
)

__all__ = [
    "Mamba",
    "init_mamba_state",
    "mamba_decode",
    "mamba_forward",
    "mamba_init",
    "ssd_reference",
]


def _conv_dim(cfg: ModelConfig) -> int:
    return cfg.d_inner + 2 * cfg.ssm_groups * cfg.ssm_state


def mamba_init(gen, cfg: ModelConfig, dtype: torch.dtype = torch.bfloat16,
               device: Optional[torch.device] = None) -> dict:
    d, di, h = cfg.d_model, cfg.d_inner, cfg.ssm_heads
    cdim = _conv_dim(cfg)
    dev = gen.device if gen is not None else device

    def init(shape, **kw):
        return dense_init(gen, shape, dtype=dtype, device=device, **kw)

    return {
        "w_in": init((d, 2 * di + 2 * cfg.ssm_groups * cfg.ssm_state + h)),
        "conv_w": init((cfg.ssm_conv_width, cdim), fan_in=cfg.ssm_conv_width),
        "conv_b": torch.zeros((cdim,), dtype=dtype, device=dev),
        "a_log": torch.zeros((h,), dtype=torch.float32, device=dev),  # A = -exp(a_log) = -1
        "dt_bias": torch.full((h,), -2.0, dtype=torch.float32, device=dev),  # softplus ~ 0.12
        "d_skip": torch.ones((h,), dtype=torch.float32, device=dev),
        "gate_norm": torch.zeros((di,), dtype=dtype, device=dev),
        "w_out": init((di, d), fan_in=di),
    }


class Mamba(ParamModule):
    """One Mamba2 mixer: ``w_in`` (D, 2·DI + 2·G·N + H), ``conv_w`` (W, C),
    ``conv_b``, ``a_log``, ``dt_bias`` and ``d_skip`` (H,) in float32,
    ``gate_norm`` (DI,) and ``w_out`` (DI, D), in JAX's (in, out) layout."""

    def __init__(self, gen, cfg: ModelConfig, *, dtype: torch.dtype,
                 device: Optional[torch.device] = None) -> None:
        super().__init__(mamba_init(gen, cfg, dtype, device))


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    di, g, n = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state
    z = proj[..., :di]
    xbc = proj[..., di: di + di + 2 * g * n]
    dt = proj[..., di + di + 2 * g * n:].float()
    return z, xbc, dt


def _causal_conv(params, xbc: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Depthwise causal conv, width W: y_t = sum_w w[w]*x[t-W+1+w] + b, the
    products summed in the input dtype, silu in float32."""
    w = cfg.ssm_conv_width
    pad = F.pad(xbc, (0, 0, w - 1, 0))
    out = sum(pad[:, i: i + xbc.shape[1], :] * params["conv_w"][i][None, None, :]
              for i in range(w))
    return F.silu((out + params["conv_b"]).float()).to(xbc.dtype)


def _split_xbc(xbc: torch.Tensor, cfg: ModelConfig):
    b, l, _ = xbc.shape
    di, g, n, h, p = cfg.d_inner, cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    xs = xbc[..., :di].reshape(b, l, h, p)
    bs = xbc[..., di: di + g * n].reshape(b, l, g, n)
    cs = xbc[..., di + g * n:].reshape(b, l, g, n)
    return xs, bs, cs


def _intra_decay(cum: torch.Tensor) -> torch.Tensor:
    """decay[b,c,i,j,h] = exp(cum_i - cum_j) for i >= j, else 0, from the
    inclusive cumsum ``cum`` (B,NC,Q,H) of dt·A: masked before ``exp`` (see
    the module docstring)."""
    q = cum.shape[2]
    diff = cum[:, :, :, None, :] - cum[:, :, None, :, :]     # (B,NC,Qi,Qj,H)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=cum.device))
    diff = torch.where(tri[None, None, :, :, None], diff, -torch.inf)  # frees the unmasked
    return torch.exp(diff)


def _ssd_chunked(xs, dt, a, bs, cs, cfg: ModelConfig):
    """SSD: xs (B,L,H,P) fp32, dt (B,L,H) fp32 (post-softplus), a (H,)
    negative, bs/cs (B,L,G,N) fp32.  Returns y (B,L,H,P) fp32 and the final
    state (B,H,P,N)."""
    b, l, h, p = xs.shape
    g, n = bs.shape[2], bs.shape[3]
    q = min(cfg.ssm_chunk, l)
    assert l % q == 0, f"L={l} % chunk={q}"
    nc = l // q
    rep = h // g

    da = dt * a[None, None, :]                          # (B,L,H) <= 0
    xdt = xs * dt[..., None]                            # input scaled by dt

    # chunked views
    da_c = da.reshape(b, nc, q, h)
    x_c = xdt.reshape(b, nc, q, h, p)
    b_c = bs.reshape(b, nc, q, g, n)
    c_c = cs.reshape(b, nc, q, g, n)

    cum = torch.cumsum(da_c, dim=2)                     # (B,NC,Q,H) inclusive
    total = cum[:, :, -1:, :]                           # (B,NC,1,H)

    y_intra = _ssd_intra(c_c, b_c, x_c, cum, rep)
    s_c = _ssd_chunk_states(b_c, x_c, cum, total, rep)
    y_inter, s = _ssd_inter(s_c, c_c, cum, total, rep)
    y = (y_intra + y_inter).reshape(b, l, h, p)
    return y, s


def _ssd_intra(c_c, b_c, x_c, cum, rep: int) -> torch.Tensor:
    """The intra-chunk (attention-like) term (B,NC,Q,H,P): y_i = sum_{j<=i}
    C_i·B_j exp(cum_i - cum_j) x_j dt_j within each chunk."""
    decay = _intra_decay(cum)                                # (B,NC,Qi,Qj,H)
    cb = torch.einsum("bcign,bcjgn->bcgij", c_c, b_c)        # (B,NC,G,Qi,Qj)
    cb = torch.repeat_interleave(cb, rep, dim=2)             # (B,NC,H,Qi,Qj)
    scores = cb * decay.movedim(-1, 2)                       # (B,NC,H,Qi,Qj)
    del cb, decay
    return torch.einsum("bchij,bcjhp->bcihp", scores, x_c)


def _ssd_chunk_states(b_c, x_c, cum, total, rep: int) -> torch.Tensor:
    """Each chunk's state (B,NC,H,P,N): S_c = sum_j exp(total - cum_j) B_j
    (x_j dt_j)."""
    w_state = torch.exp(total - cum)                         # (B,NC,Q,H)
    b_h = torch.repeat_interleave(b_c, rep, dim=3)           # (B,NC,Q,H,N)
    return torch.einsum("bcjhn,bcjhp->bchpn", b_h, x_c * w_state[..., None])


def _ssd_inter(s_c, c_c, cum, total, rep: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The inter-chunk scan, in chunk order (JAX's ``lax.scan``): the state
    entering each chunk, then y_inter[i] = exp(cum_i) C_i·S_prev (B,NC,Q,H,P)
    and the final state (B,H,P,N)."""
    b, nc, h, p, n = s_c.shape
    chunk_decay = torch.exp(total[:, :, 0, :])               # (B,NC,H)
    s = torch.zeros((b, h, p, n), dtype=torch.float32, device=s_c.device)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, c][..., None, None] + s_c[:, c]
    s_prev = torch.stack(s_prevs, dim=1)                     # (B,NC,H,P,N)
    c_h = torch.repeat_interleave(c_c, rep, dim=3)           # (B,NC,Q,H,N)
    return torch.einsum("bcihn,bchpn->bcihp", c_h, s_prev) * torch.exp(cum)[..., None], s


def ssd_reference(xs, dt, a, bs, cs):
    """Naive O(L) recurrence oracle (fp32): the ground truth for tests."""
    b, l, h, p = xs.shape
    g, n = bs.shape[2], bs.shape[3]
    rep = h // g
    da = dt * a[None, None, :]
    xdt = xs * dt[..., None]
    b_h = torch.repeat_interleave(bs, rep, dim=2)
    c_h = torch.repeat_interleave(cs, rep, dim=2)
    state = torch.zeros((b, h, p, n), dtype=torch.float32, device=xs.device)
    ys = []
    for t in range(l):
        state = state * torch.exp(da[:, t])[..., None, None] + torch.einsum(
            "bhn,bhp->bhpn", b_h[:, t], xdt[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", c_h[:, t], state))
    return torch.stack(ys, dim=1), state


_MIXER = ("conv_w", "conv_b", "dt_bias", "a_log", "d_skip", "gate_norm")


def mamba_forward(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence Mamba2 block (train / prefill).  Under a mesh the
    mixer between the two projections runs on each rank's batch rows
    (``pspec.local_call``), replicated over ``model``: DTensor cannot place
    the padded conv's views on every torch release, and the gated norm
    needs every head of a row."""
    proj = x @ params["w_in"]
    small = tuple(params[n] for n in _MIXER)
    if is_dtensor(proj):
        from torch.distributed.tensor import Replicate

        rows = row_placements(proj, proj.placements)
        whole = [Replicate()] * len(rows)
        grads = weight_grad_placements(rows)
        y = local_call(lambda p, *w: _mixer(p, dict(zip(_MIXER, w)), cfg),
                       (proj, *small), (rows,) + (whole,) * len(small), rows,
                       (rows,) + (grads,) * len(small))
    else:
        y = _mixer(proj, dict(zip(_MIXER, small)), cfg)
    return reduce_boundary(y, x.dtype) @ params["w_out"]


def _mixer(proj: torch.Tensor, params: dict, cfg: ModelConfig) -> torch.Tensor:
    """The input projection's output (B, L, 2·DI + 2·G·N + H) -> the gated,
    normed SSD output (B, L, DI): conv, SSD, skip, gate."""
    z, xbc, dt = _split_proj(proj, cfg)
    xbc = _causal_conv(params, xbc, cfg)
    xs, bs, cs = _split_xbc(xbc, cfg)
    dt = F.softplus(dt + params["dt_bias"])
    a = -torch.exp(params["a_log"])
    y, _ = _ssd_chunked(xs.float(), dt, a, bs.float(), cs.float(), cfg)
    y = y + params["d_skip"][None, None, :, None] * xs.float()
    b, l = proj.shape[:2]
    y = y.reshape(b, l, cfg.d_inner).to(proj.dtype)
    return _gated_norm(params, y, z, cfg)


def _gated_norm(params, y: torch.Tensor, z: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RMSNorm of y gated by silu(z): silu in float32, the product in y's
    dtype."""
    return rms_norm(y * F.silu(z.float()).to(y.dtype), params["gate_norm"], cfg.norm_eps)


def init_mamba_state(cfg: ModelConfig, batch: int, dtype: torch.dtype = torch.bfloat16,
                     device: Optional[torch.device] = None) -> dict:
    return {
        "conv": torch.zeros((batch, cfg.ssm_conv_width - 1, _conv_dim(cfg)), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
                           dtype=torch.float32, device=device),
    }


def mamba_decode(params, x: torch.Tensor, state: dict,
                 cfg: ModelConfig) -> tuple[torch.Tensor, dict]:
    """One-token recurrent step.  x (B, 1, D).  Shifts the conv ring and
    advances the SSM state in ``state`` in place; returns (out (B, 1, D),
    state)."""
    proj = x @ params["w_in"]
    small = tuple(params[n] for n in _MIXER)
    conv, ssm = state["conv"], state["ssm"]
    if is_dtensor(proj):
        from torch.distributed.tensor import Replicate

        rows = seq_placements(ssm, {0: 0})
        whole = [Replicate()] * len(rows)
        heads, chans = shard_of(ssm, 1), shard_of(conv, 2)
        y = local_call(
            lambda p, c, st, *w: _mixer_step(p, c, st, dict(zip(_MIXER, w)), cfg, heads, chans),
            (proj, conv, ssm, *small),
            (rows, conv.placements, ssm.placements) + (whole,) * len(small), rows)
    else:
        y = _mixer_step(proj, conv, ssm, dict(zip(_MIXER, small)), cfg)
    return y @ params["w_out"], state


def _mixer_step(proj: torch.Tensor, conv: torch.Tensor, ssm: torch.Tensor, params: dict,
                cfg: ModelConfig, heads=None, chans=None) -> torch.Tensor:
    """The input projection's output (B, 1, ...) -> the gated, normed step
    output (B, 1, DI), the conv ring and SSM state advanced in place.
    ``heads`` and ``chans`` (``pspec.shard_of``): ``ssm`` holds this rank's
    heads, ``conv`` its channels."""
    z, xbc_new, dt = _split_proj(proj, cfg)
    # conv over the ring buffer: window = [conv_state ; xbc_new], in float32
    ring = conv if chans is None else gather_over(conv, 2, chans[0])
    window = torch.cat([ring, xbc_new], dim=1)               # (B, W, C)
    out = (torch.einsum("bwc,wc->bc", window.float(), params["conv_w"].float())
           + params["conv_b"].float())
    xbc = F.silu(out)[:, None, :].to(proj.dtype)              # (B,1,C)
    xs, bs, cs = _split_xbc(xbc, cfg)
    dt = F.softplus(dt + params["dt_bias"])                  # (B,1,H)
    a = -torch.exp(params["a_log"])
    rep = cfg.ssm_heads // cfg.ssm_groups

    da = (dt[:, 0] * a[None, :]).float()                     # (B,H)
    xs = xs[:, 0].float()
    xdt = xs * dt[:, 0][..., None]
    b_h = torch.repeat_interleave(bs[:, 0].float(), rep, dim=1)   # (B,H,N)
    c_h = torch.repeat_interleave(cs[:, 0].float(), rep, dim=1)
    d_skip = params["d_skip"]
    if heads is not None:  # this rank's heads of every per-head term
        n = ssm.shape[1]
        own = slice(heads[1] * n, (heads[1] + 1) * n)
        da, xs, xdt, b_h, c_h = (v[:, own] for v in (da, xs, xdt, b_h, c_h))
        d_skip = d_skip[own]
    ssm.mul_(torch.exp(da)[..., None, None]).add_(torch.einsum("bhn,bhp->bhpn", b_h, xdt))
    if chans is None:
        conv.copy_(window[:, 1:, :])
    else:
        n = conv.shape[2]
        conv.copy_(window[:, 1:, chans[1] * n:(chans[1] + 1) * n])
    y = torch.einsum("bhn,bhpn->bhp", c_h, ssm)
    y = y + d_skip[None, :, None] * xs
    if heads is not None:
        y = gather_over(y, 1, heads[0])
    y = y.reshape(proj.shape[0], 1, cfg.d_inner).to(proj.dtype)
    return _gated_norm(params, y, z, cfg)
