"""Model FLOPs and kernel operations and bytes, counted from a
configuration's shapes (the HF keys of ``configs/<name>.json``), never from
the program's own ops: the count is the same whatever implements the step.

``matmul_params`` counts the weights of every matrix product a token goes
through once: the attention projections, the dense or active expert FFNs
(the routed ``num_experts_per_tok`` and the shared ones) and the router, and
the output head.  The embedding gather is no product and is left out, as are
the norms.  A forward costs 2 FLOPs a parameter a token, plus causal
attention's scores and weighted values: 2 FLOPs for each of the
(qk + v) head dims of each visible (query, key) pair of each head.

On a chip's share (``spec.py`` ``share``) the counts are this chip's: the
held heads, the router at its published width, the routed experts at
``num_experts_per_tok`` x held / published a token (the tokens this chip's
experts take), the shared experts on every token.
"""

from __future__ import annotations

from fractions import Fraction

from fsbench import peaks, spec


def _is_mla(c: dict) -> bool:
    return bool(c.get("kv_lora_rank"))


def attention_params(c: dict) -> int:
    d, h = c["hidden_size"], c["num_attention_heads"]
    if _is_mla(c):
        nope, pe, v = c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"]
        r = c["kv_lora_rank"]
        q = (d * c["q_lora_rank"] + c["q_lora_rank"] * h * (nope + pe)
             if c.get("q_lora_rank") else d * h * (nope + pe))
        return q + d * (r + pe) + r * h * (nope + v) + h * v * d
    hd = spec.head_dim(c)
    kv = c["num_key_value_heads"]
    return 2 * d * h * hd + 2 * d * kv * hd


def _exact(x: Fraction) -> int | Fraction:
    return x.numerator if x.denominator == 1 else x


def routed_per_token(c: dict) -> int | Fraction:
    """Routed experts a token takes on this chip: all ``num_experts_per_tok``,
    or their share on the experts held here."""
    held = c["n_routed_experts"]
    return _exact(Fraction(c["num_experts_per_tok"] * held,
                           spec.published(c, "n_routed_experts")))


def ffn_params(c: dict, layer: int) -> int | Fraction:
    """Active FFN parameters of ``layer``: the dense FFN, or the router and
    the routed experts a token takes plus the shared ones."""
    d = c["hidden_size"]
    if c.get("n_routed_experts") and layer >= c.get("first_k_dense_replace", 0):
        per = 3 * d * c["moe_intermediate_size"]
        return (d * spec.published(c, "n_routed_experts")
                + (routed_per_token(c) + c.get("n_shared_experts", 0)) * per)
    return 3 * d * c["intermediate_size"]


def matmul_params(c: dict) -> int | Fraction:
    """An integer; a fraction only where a share's routed experts a token
    (``routed_per_token``) make it one."""
    layers = c["num_hidden_layers"]
    body = sum(attention_params(c) + ffn_params(c, i) for i in range(layers))
    return _exact(Fraction(body + c["hidden_size"] * c["vocab_size"]))


def head_dims(c: dict) -> tuple[int, int]:
    """(query/key head dim, value head dim)."""
    if _is_mla(c):
        return c["qk_nope_head_dim"] + c["qk_rope_head_dim"], c["v_head_dim"]
    hd = spec.head_dim(c)
    return hd, hd


def causal_pairs(seq: int) -> int:
    """(query, key) pairs a causal mask leaves visible in one sequence."""
    return seq * (seq + 1) // 2


def attention_flops(c: dict, batch: int, seq: int) -> int:
    qk, v = head_dims(c)
    return (2 * (qk + v) * c["num_attention_heads"] * causal_pairs(seq) * batch
            * c["num_hidden_layers"])


def forward_flops(c: dict, batch: int, seq: int) -> int:
    return 2 * matmul_params(c) * batch * seq + attention_flops(c, batch, seq)


def train_flops(c: dict, batch: int, seq: int) -> int:
    """A training step: the forward and twice it for the backward."""
    return 3 * forward_flops(c, batch, seq)


def flash_fwd_bound_s(c: dict, batch: int, seq: int) -> float:
    """Least seconds of one causal flash forward call (one layer) at bf16:
    4·D operations for each (query head, visible key) pair (q.k and p.v),
    against q, k, v read once and O written once (2 bytes an element);
    the larger of the two, as chip_smoke.py's check_flash counts it."""
    h, kv = c["num_attention_heads"], c["num_key_value_heads"]
    d = spec.head_dim(c)
    ops = 4 * batch * h * d * causal_pairs(seq)
    nbytes = 2 * (2 * batch * seq * h * d + 2 * batch * seq * kv * d)
    return max(ops / peaks.BF16_FLOPS, nbytes / peaks.HBM_BYTES_PER_S)
