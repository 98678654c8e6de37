"""Plain float32 reference of the decoder stacks of ``phi3-medium-14b.json``
(dense GQA, SwiGLU) and ``deepseek-v2-lite-16b.json`` (MLA without a query
LoRA, a leading dense layer, then MoE layers of routed and shared experts),
written from the published descriptions as the configuration files run
them (the published keys with ``run`` on top: the port's departures, each
with its reason under ``assumed``), in plain PyTorch: no kernel, cache or
batching of the port, and nothing imported from it.

Conventions (the configuration files' ``assumed``): RMSNorm scales are
1 + gamma; RoPE rotates the two halves of a head (theta from the file);
the attention scale is 1/sqrt(query/key head dim); the MoE router takes a
float32 softmax over all experts, the top ``num_experts_per_tok`` renormalised
to sum to one, and each expert takes at most C assignments of a group of
``moe_group_size`` tokens (C = max(8, ceil8(int(group · k / E · cf)))),
first come in (token, choice) order; the rest are dropped.

``forward`` works layer by layer: the caller's ``layer(group)`` gives the
weights of one group (``weights.draw``), which are cast to float32 and
freed before the next, so it fits beside nothing else on the card.  With
``fp8`` every projection's weight (per output column) and input (per
token) is rounded to float8 e4m3 first: the control, one precision below
the configuration's bfloat16.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

__all__ = ["forward", "served_gap"]


@contextlib.contextmanager
def _exact_float32():
    """TF32 off for the reference's float32 products."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class _Matmul:
    def __init__(self, fp8: bool) -> None:
        self.fp8 = fp8

    def __call__(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            x, w = _fp8(x, -1), _fp8(w, -2)
        return x @ w


def _rms(x, g, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + g)


def _rope(x, pos, theta):
    """x (S, heads, dim): the halves rotated by pos · theta^(-2i/dim)."""
    dim = x.shape[-1]
    inv = theta ** (-torch.arange(0, dim, 2, dtype=torch.float64, device=x.device) / dim)
    ang = (pos.double()[:, None] * inv).float()
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., : dim // 2], x[..., dim // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _causal_softmax_av(q, k, v, scale):
    """q (S, H, dq), k (S, H, dq), v (S, H, dv) -> (S, H·dv)."""
    s = q.shape[0]
    scores = torch.einsum("shd,thd->hst", q, k) * scale
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    return torch.einsum("hst,thd->shd", torch.softmax(scores, -1), v).reshape(s, -1)


def _gqa(c, p, h, mm):
    """One prompt's attention, h (S, D)."""
    s, d = h.shape
    nh, kv = c["num_attention_heads"], c["num_key_value_heads"]
    hd = c.get("head_dim") or d // nh
    pos = torch.arange(s, device=h.device)
    q = _rope(mm(h, p["mixer.wq"]).view(s, nh, hd), pos, c["rope_theta"])
    k = _rope(mm(h, p["mixer.wk"]).view(s, kv, hd), pos, c["rope_theta"])
    v = mm(h, p["mixer.wv"]).view(s, kv, hd)
    k, v = k.repeat_interleave(nh // kv, 1), v.repeat_interleave(nh // kv, 1)
    return mm(_causal_softmax_av(q, k, v, 1.0 / math.sqrt(hd)), p["mixer.wo"])


def _mla(c, p, h, mm):
    s = h.shape[0]
    nh, nope, pe, vd, r = (c["num_attention_heads"], c["qk_nope_head_dim"],
                           c["qk_rope_head_dim"], c["v_head_dim"], c["kv_lora_rank"])
    pos = torch.arange(s, device=h.device)
    q = mm(h, p["mixer.wq"]).view(s, nh, nope + pe)
    q_pe = _rope(q[..., nope:], pos, c["rope_theta"])
    kv_a = mm(h, p["mixer.wkv_a"])
    c_kv = _rms(kv_a[:, :r], p["mixer.kv_norm"], c["rms_norm_eps"])
    k_pe = _rope(kv_a[:, None, r:], pos, c["rope_theta"]).expand(s, nh, pe)
    kv = mm(c_kv, p["mixer.wkv_b"]).view(s, nh, nope + vd)
    qk = torch.cat([q[..., :nope], q_pe], -1)
    k = torch.cat([kv[..., :nope], k_pe], -1)
    out = _causal_softmax_av(qk, k, kv[..., nope:], 1.0 / math.sqrt(nope + pe))
    return mm(out, p["mixer.wo"])


def _swiglu(x, wg, wu, wd, mm):
    return mm(F.silu(mm(x, wg)) * mm(x, wu), wd)


def _moe(c, p, x, mm):
    """x (T, D), T a multiple of the group size: (routed + shared experts,
    the load-balance loss coef · E · sum_e mean prob_e · top-1 share_e over
    all T tokens)."""
    t, d = x.shape
    e, k = c["n_routed_experts"], c["num_experts_per_tok"]
    gs = min(c["moe_group_size"], t)
    if t % gs:
        raise ValueError(f"{t} tokens are no whole number of {gs}-token routing groups")
    cap = int(gs * k / e * c["capacity_factor"])
    cap = max(8, (cap + 7) // 8 * 8)
    probs = torch.softmax(x @ p["ffn.router"], -1)
    gate, idx = torch.topk(probs, k, -1)
    if c["norm_topk_prob"]:
        gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    top1 = torch.zeros(e, device=x.device).index_add_(
        0, idx[:, 0], torch.ones(t, device=x.device)) / t
    aux = c["router_aux_coef"] * e * torch.sum(probs.mean(0) * top1)
    routed = []
    for g0 in range(0, t, gs):
        flat = idx[g0:g0 + gs].reshape(-1)           # (token, choice) order
        for ex in range(e):
            pos = torch.nonzero(flat == ex).flatten()[:cap]
            if pos.numel():
                routed.append((g0 + pos // k, ex, g0 * k + pos))
    gate = gate.reshape(-1)
    ys = [_swiglu(x[tok], p["ffn.w_gate"][ex], p["ffn.w_up"][ex], p["ffn.w_down"][ex], mm)
          * gate[slot, None] for tok, ex, slot in routed]
    out = torch.zeros_like(x).index_add(0, torch.cat([r[0] for r in routed]), torch.cat(ys))
    if "ffn.shared.w_gate" in p:
        out = out + _swiglu(x, p["ffn.shared.w_gate"], p["ffn.shared.w_up"],
                            p["ffn.shared.w_down"], mm)
    return out, aux


def _block(c, p, x, i, mm):
    """Layer i over x (n, S, D): (its output, its load-balance loss)."""
    if any(c.get(k) for k in ("rope_scaling", "sliding_window", "q_lora_rank", "share",
                                "extra_leaves")):
        raise ValueError("the reference has no rope scaling, sliding window, query LoRA, "
                         "chip's share or extra leaves")
    n, s, _ = x.shape
    mixer = _mla if c.get("kv_lora_rank") else _gqa
    h = _rms(x, p["norm1"], c["rms_norm_eps"])
    x = x + torch.stack([mixer(c, p, h[j], mm) for j in range(n)])
    h = _rms(x, p["norm2"], c["rms_norm_eps"]).reshape(n * s, -1)
    if "ffn.router" in p:
        y, aux = _moe(c, p, h, mm)
    else:
        y, aux = _swiglu(h, p["ffn.w_gate"], p["ffn.w_up"], p["ffn.w_down"], mm), 0.0
    return x + y.view(n, s, -1), aux


def _layer_f32(raw: dict, requires_grad: bool = False) -> dict:
    """A layer group's weights by leaf name ("mixer.wq", ...), float32."""
    return {name.split(".", 2)[2]: w.float().requires_grad_(requires_grad)
            for name, w in raw.items()}


def forward(c: dict, tokens: torch.Tensor, layer, *, fp8: bool = False) -> torch.Tensor:
    """Float32 logits (n, S, V) of the prompts ``tokens`` (n, S).
    ``layer(g)`` returns weight group g (0 the embedding, 1..L the layers,
    L+1 the head)."""
    mm = _Matmul(fp8)
    n = tokens.shape[0]
    with _exact_float32(), torch.no_grad():
        x = layer(0)["embed"].float()[tokens]                       # (n, S, D)
        for i in range(c["num_hidden_layers"]):
            x, _ = _block(c, _layer_f32(layer(i + 1)), x, i, mm)
        head = layer(c["num_hidden_layers"] + 1)
        xf = _rms(x, head["final_norm"].float(), c["rms_norm_eps"])
        w = head["lm_head"].float()
        return torch.stack([mm(xf[j], w) for j in range(n)])


def served_gap(ref_logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """How far each served token's reference logit lies below the reference's
    best at its position: (n, S) float32, 0 where the served token is the
    reference's argmax."""
    best = ref_logits.max(-1).values
    return best - ref_logits.gather(-1, served[..., None].long()).squeeze(-1)


class _STEfp8(_Matmul):
    """The control's products under a gradient: float8 values forward, the
    gradient passed straight through in float32."""

    def __call__(self, x, w):
        if self.fp8:
            x = x + (_fp8(x, -1) - x).detach()
            w = w + (_fp8(w, -2) - w).detach()
        return x @ w


def _loss_and_grads(c: dict, params: dict, tokens: torch.Tensor, mm) -> tuple:
    """(lm loss, total loss, float32 gradients by name) of one batch, layer
    by layer: a forward that keeps each layer's input, then each layer
    again under autograd from the top, handed the gradient of its output
    (so only one layer's activations live at a time)."""
    layers, eps = c["num_hidden_layers"], c["rms_norm_eps"]
    names = [sorted(n for n in params if n.startswith(f"{pre}.{j}."))
             for pre, j in _layer_names(c)]
    grads, xs, aux_total = {}, [], 0.0
    with torch.no_grad():
        x = params["embed"].float()[tokens]
        for i in range(layers):
            xs.append(x)
            x, aux = _block(c, _layer_f32({n: params[n] for n in names[i]}), x, i, mm)
            aux_total += float(aux)
    h = x.requires_grad_()
    head = {n: params[n].float().requires_grad_() for n in ("final_norm", "lm_head")}
    logits = mm(_rms(h, head["final_norm"], eps), head["lm_head"])
    lm = F.cross_entropy(logits[:, :-1].reshape(-1, logits.shape[-1]),
                         tokens[:, 1:].reshape(-1))
    lm.backward()
    del logits
    grads.update((n, w.grad) for n, w in head.items())
    g = h.grad
    for i in reversed(range(layers)):
        xin = xs.pop().requires_grad_()
        w = {n: params[n].float().requires_grad_() for n in names[i]}
        y, aux = _block(c, {n.split(".", 2)[2]: t for n, t in w.items()}, xin, i, mm)
        (torch.sum(y * g) + aux).backward()
        grads.update((n, t.grad) for n, t in w.items())
        g = xin.grad
        del y, xin, w
    grads["embed"] = torch.zeros_like(params["embed"], dtype=torch.float32).index_add_(
        0, tokens.reshape(-1), g.reshape(-1, g.shape[-1]))
    lm = float(lm.detach())
    return lm, lm + aux_total, grads


def _layer_names(c: dict) -> list[tuple[str, int]]:
    dense = c.get("first_k_dense_replace", 0) if c.get("n_routed_experts") else 0
    return [("prefix", i) if i < dense else ("tail", i - dense)
            for i in range(c["num_hidden_layers"])]


def train(c: dict, batches: list, layer, opt: dict, *, fp8: bool = False) -> dict:
    """Steps of AdamW from the weights ``layer`` gives, one a batch of
    ``batches`` ((n, S) token tensors), as the configuration states them:
    bfloat16 weights, float32 products, gradients and moments; the
    gradient clipped to ``opt['clip']`` by its global norm; the update
    (m/bc1)/(sqrt(v/bc2) + eps) + weight_decay · w at the warm-up-cosine
    rate of ``opt``, written back in bfloat16.  Returns each step's
    ``loss`` (the next-token loss plus the load-balance loss), the first
    clipped gradient's norm by leaf, and the norm of each leaf's change
    after the last step."""
    mm = _STEfp8(fp8)
    b1, b2, eps, wd = opt["b1"], opt["b2"], opt["eps"], opt["weight_decay"]
    groups = c["num_hidden_layers"] + 2
    params = {}
    for g in range(groups):
        params.update(layer(g))
    m = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
    v = {n: torch.zeros_like(p, dtype=torch.float32) for n, p in params.items()}
    out = {"loss": [], "lm_loss": []}
    with _exact_float32():
        for step, tokens in enumerate(batches, start=1):
            lm, total, grads = _loss_and_grads(c, params, tokens, mm)
            out["loss"].append(total)
            out["lm_loss"].append(lm)
            with torch.no_grad():
                gnorm = torch.sqrt(sum(torch.sum(t * t) for t in grads.values()))
                scale = torch.clamp(opt["clip"] / torch.clamp(gnorm, min=1e-9), max=1.0)
                if step == 1:
                    out["grad_norms"] = {n: float(t.norm() * scale) for n, t in grads.items()}
                rate = _warmup_cosine(opt, step)
                bc1, bc2 = 1.0 - b1 ** step, 1.0 - b2 ** step
                for n, p in params.items():
                    gs = grads.pop(n) * scale
                    m[n].mul_(b1).add_((1 - b1) * gs)
                    v[n].mul_(b2).add_((1 - b2) * gs * gs)
                    upd = (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + eps) + wd * p.float()
                    p.copy_((p.float() - rate * upd).to(p.dtype))
    del m, v
    with torch.no_grad():
        out["change_norms"] = {}
        for g in range(groups):
            for n, p0 in layer(g).items():
                out["change_norms"][n] = float((params[n].float() - p0.float()).norm())
    return out


def _warmup_cosine(opt: dict, step: int) -> float:
    peak, warm, total = opt["lr"], opt["warmup_steps"], opt["total_steps"]
    if step < warm:
        return peak * step / max(warm, 1)
    t = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return peak * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * t)))
