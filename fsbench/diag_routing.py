#!/usr/bin/env python3
"""The look behind what the deepseek prefill cell compares (not run by the
benchmark's own runs): over one batch of the cell at its own size, each
token's experts in every MoE layer (its top-k, less what capacity drops),
in the program and in the plain reference, and the served tokens' gaps to
the reference's best split by whether the two agree.  Where the widest
gaps sit only on tokens served differently, or reached by them, they
measure near ties of the router between bfloat16 and float32, not the
program's arithmetic.

    python3 fsbench/diag_routing.py --workload deepseek-v2-lite-16b.prefill-2k --seeds 41 44

Prints one JSON line a seed.
"""

import argparse
import json
import sys


def kept(idx, group: int, cap: int, experts: int):
    """The expert ids each token is served by, (tokens, k) sorted, -1 where
    an assignment is dropped: at most ``cap`` a group of ``group`` tokens
    for each expert, first come in (token, choice) order (the rule the
    configuration states for both sides)."""
    import torch
    import torch.nn.functional as F

    t, k = idx.shape
    flat = idx.reshape(t // group, group * k)
    rank = F.one_hot(flat, experts).cumsum(1).gather(2, flat[..., None])[..., 0] - 1
    return torch.where(rank < cap, flat, -1).reshape(t, k).sort(-1).values


def split(gap, program: list, reference: list, prompt: int) -> dict:
    """``gap`` (tokens,) the served gaps, prompts of ``prompt`` tokens one
    after another; ``program``, ``reference`` one (tokens, k) tensor of the
    experts that serve each token a MoE layer (``kept``).  The share of
    tokens served differently by layer and in any layer, and the gaps of
    three sets of tokens: served alike in every layer; served alike, with
    every token before them in their prompt too (nothing routed
    differently reaches them, by attention or by capacity); the others."""
    import torch

    differs = torch.stack([(a != r).any(-1) for a, r in zip(program, reference)])
    other = differs.any(0)
    clean = (other.reshape(-1, prompt).cumsum(1) == 0).reshape(-1)
    widest = gap.topk(min(20, gap.numel())).indices

    def stat(f, mask):
        return float(f(gap[mask])) if mask.any() else None

    return {"tokens": int(gap.numel()), "moe_layers": len(program),
            "share_served_differently_by_layer": differs.float().mean(1).tolist(),
            "share_served_differently_any_layer": float(other.float().mean()),
            "tokens_alike_with_their_prefix": int(clean.sum()),
            "widest_gap_alike_with_their_prefix": stat(torch.max, clean),
            "widest_gap_alike": stat(torch.max, ~other),
            "widest_gap_differently": stat(torch.max, other),
            "mean_gap_alike": stat(torch.mean, ~other),
            "mean_gap_differently": stat(torch.mean, other),
            "widest_20_served_differently": int(other[widest].sum())}


def look(cell, seed: int, device) -> dict:
    """One batch of ``cell`` served by the program with its routing
    recorded, then the reference over the same prompts with its own."""
    import torch
    from repro_torch.models import moe

    from fsbench import spec, trace, weights
    from fsbench.kinds.session_prefill import SessionPrefill

    ref = spec.reference(cell.config)
    job = SessionPrefill(cell, seed, device)
    job.setup()
    program, reference = [], []
    route, ref_moe = moe._route_parts, ref._moe

    c = cell.config
    e, k, group = c["n_routed_experts"], c["num_experts_per_tok"], c["moe_group_size"]
    cap = max(8, (int(group * k / e * c["capacity_factor"]) + 7) // 8 * 8)

    def record(params, xg, cfg):
        out = route(params, xg, cfg)
        program.append(kept(out[1].reshape(-1, k).cpu(), group, cap, e))
        return out

    def record_ref(c, p, x, mm):
        probs = torch.softmax(x @ p["ffn.router"], -1)
        reference.append(kept(torch.topk(probs, k, -1)[1].cpu(), group, cap, e))
        return ref_moe(c, p, x, mm)

    moe._route_parts = record
    try:
        with torch.no_grad():
            _, _, _, tokens, served = job._batch(0, trace.Spans())
    finally:
        moe._route_parts = route
    job.release()
    ref._moe = record_ref
    try:
        logits = ref.forward(cell.config, tokens,
                             lambda g: weights.draw(cell.config, seed, g, job.dev))
    finally:
        ref._moe = ref_moe
    gap = ref.served_gap(logits, served).reshape(-1).cpu()
    return {"seed": seed, **split(gap, program, reference, tokens.shape[1])}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import run as entry

    entry._environment()
    from fsbench import spec

    cell = spec.cell(spec.load(), args.workload)
    for seed in args.seeds:
        print(json.dumps({"workload": args.workload, **look(cell, seed, "cuda")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
