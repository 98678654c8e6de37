"""A configuration's weights, made by the benchmark from the seed: the
inputs both sides get.  The program loads them into its model; the plain
reference draws the same group again when it needs it.

Weights come in groups: the embedding, each layer, the head.  Each group is
one ``randn`` call in bfloat16 on the device (and one in float32 for the
routers, which the port keeps in float32), from a generator seeded by
(seed, group), so a group can be drawn again alone.  Each leaf is then
scaled by 1/sqrt(fan_in); norm scales are zero (the port's 1 + gamma).
Leaf names and shapes are the port's (``LM.named_parameters``), in its
(in, out) layout.

A chip's share (``spec.py``) draws the held experts' stacks and heads' slices
(the top-level counts) and a router of the published width; a file's
``extra_leaves`` come after a layer's own leaves, in the order listed, and
are drawn after them.
"""

from __future__ import annotations

import math

import torch

from fsbench import spec
from fsbench.generate import derived_seed

__all__ = ["draw", "groups", "load", "num_groups"]

_KINDS = ("bf16", "fp32", "zero")


def _layer_leaves(c: dict, i: int) -> tuple[list, list]:
    """Layer i's own leaves, and its ``extra_leaves``."""
    d, h = c["hidden_size"], c["num_attention_heads"]
    dense_prefix = c.get("first_k_dense_replace", 0) if c.get("n_routed_experts") else 0
    name = f"prefix.{i}" if i < dense_prefix else f"tail.{i - dense_prefix}"
    leaves = [("norm1", (d,), 0, "zero"), ("norm2", (d,), 0, "zero")]
    if c.get("kv_lora_rank"):
        nope, pe, v, r = (c["qk_nope_head_dim"], c["qk_rope_head_dim"], c["v_head_dim"],
                          c["kv_lora_rank"])
        if c.get("q_lora_rank"):
            q = c["q_lora_rank"]
            leaves += [("mixer.wq_a", (d, q), d, "bf16"), ("mixer.q_norm", (q,), 0, "zero"),
                       ("mixer.wq_b", (q, h * (nope + pe)), q, "bf16")]
        else:
            leaves.append(("mixer.wq", (d, h * (nope + pe)), d, "bf16"))
        leaves += [("mixer.wkv_a", (d, r + pe), d, "bf16"),
                   ("mixer.kv_norm", (r,), 0, "zero"),
                   ("mixer.wkv_b", (r, h * (nope + v)), r, "bf16"),
                   ("mixer.wo", (h * v, d), h * v, "bf16")]
    else:
        kv, hd = c["num_key_value_heads"], spec.head_dim(c)
        leaves += [("mixer.wq", (d, h * hd), d, "bf16"), ("mixer.wk", (d, kv * hd), d, "bf16"),
                   ("mixer.wv", (d, kv * hd), d, "bf16"), ("mixer.wo", (h * hd, d), h * hd, "bf16")]
    moe = bool(c.get("n_routed_experts")) and i >= dense_prefix
    if moe:
        e, f = c["n_routed_experts"], c["moe_intermediate_size"]
        fs = f * c.get("n_shared_experts", 0)
        leaves += [("ffn.router", (d, spec.published(c, "n_routed_experts")), d, "fp32"),
                   ("ffn.w_gate", (e, d, f), d, "bf16"), ("ffn.w_up", (e, d, f), d, "bf16"),
                   ("ffn.w_down", (e, f, d), f, "bf16")]
        if fs:
            leaves += [("ffn.shared.w_gate", (d, fs), d, "bf16"),
                       ("ffn.shared.w_up", (d, fs), d, "bf16"),
                       ("ffn.shared.w_down", (fs, d), fs, "bf16")]
    else:
        ff = c["intermediate_size"]
        leaves += [("ffn.w_gate", (d, ff), d, "bf16"), ("ffn.w_up", (d, ff), d, "bf16"),
                   ("ffn.w_down", (ff, d), ff, "bf16")]
    extra = c.get("extra_leaves", {})
    extra = [(n, tuple(shape), fan, kind) for n, shape, fan, kind in
             extra.get("all", []) + extra.get("moe" if moe else "dense", [])]
    return tuple([(f"{name}.{n}", shape, fan, kind) for n, shape, fan, kind in part]
                 for part in (leaves, extra))


def _check_extra(c: dict) -> None:
    for layers, leaves in c.get("extra_leaves", {}).items():
        for leaf in leaves:
            n, shape, fan, kind = leaf
            if (layers not in ("dense", "moe", "all") or kind not in _KINDS
                    or not all(isinstance(x, int) and x > 0 for x in shape)
                    or not isinstance(fan, int) or (fan <= 0) != (kind == "zero")):
                raise ValueError(f"{c['name']}: extra_leaves.{layers} {leaf!r}: want "
                                 "[name, [sizes], fan_in (0 for zero), bf16 | fp32 | zero] "
                                 "under dense, moe or all")


def _parts(c: dict, group: int) -> tuple[list, list]:
    """The group's own leaves and its extra leaves."""
    d, v = c["hidden_size"], c["vocab_size"]
    if group == 0:
        return [("embed", (v, d), d, "bf16")], []
    if group == c["num_hidden_layers"] + 1:
        return [("final_norm", (d,), 0, "zero"), ("lm_head", (d, v), d, "bf16")], []
    return _layer_leaves(c, group - 1)


def groups(c: dict) -> list[list]:
    """Leaves by group: (name, shape, fan_in, kind) with kind bf16, fp32 or
    zero.  Group 0 is the embedding, 1..L the layers, L+1 the head."""
    _check_extra(c)
    out = [sum(_parts(c, g), []) for g in range(num_groups(c))]
    for g in out:
        names = [leaf[0] for leaf in g]
        if len(set(names)) != len(names):
            raise ValueError(f"{c['name']}: a leaf drawn twice in {names}")
    return out


def num_groups(c: dict) -> int:
    return c["num_hidden_layers"] + 2


def draw(c: dict, seed: int, group: int, device) -> dict[str, torch.Tensor]:
    """The leaves of ``group``: bfloat16 (fp32 for routers) on ``device``.
    A layer's extra leaves are drawn after its own, by calls of their own,
    so that they leave its own leaves' values as they were."""
    leaves = groups(c)[group]
    gen = torch.Generator(device=device).manual_seed(derived_seed(seed, 100, group))
    out = {}
    for part in _parts(c, group):
        for kind, dtype in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            mine = [leaf for leaf in part if leaf[3] == kind]
            if not mine:
                continue
            total = sum(math.prod(shape) for _, shape, _, _ in mine)
            buf = torch.randn(total, generator=gen, device=device, dtype=dtype)
            off = 0
            for name, shape, fan, _ in mine:
                n = math.prod(shape)
                out[name] = buf[off:off + n].view(shape).mul_(1.0 / math.sqrt(fan))
                off += n
    for name, shape, _, kind in leaves:
        if kind == "zero":
            out[name] = torch.zeros(shape, dtype=torch.bfloat16, device=device)
    return out


def load(model, c: dict, seed: int, device) -> None:
    """Copies every group into ``model``'s parameters of the same names."""
    params = dict(model.named_parameters())
    with torch.no_grad():
        for g in range(num_groups(c)):
            for name, w in draw(c, seed, g, device).items():
                params.pop(name).copy_(w)
    if params:
        raise RuntimeError(f"weights.py draws no {sorted(params)}")
