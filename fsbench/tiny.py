"""A cell cut to a size the CPU runs in seconds, for the tests: the same
files, every width and count the file gives divided down, the model two
layers deep.  A chip's share (``share``) is kept as a share of the cut
count: half of it, held on one of two chips (4 of 8 experts, 2 of 4 heads)."""

from __future__ import annotations

import copy

from fsbench import spec

__all__ = ["tiny_cell", "tiny_config"]

_WIDTHS = {"hidden_size": 64, "intermediate_size": 128, "num_attention_heads": 4,
           "num_key_value_heads": 2, "num_hidden_layers": 2, "vocab_size": 512,
           "kv_lora_rank": 32, "qk_nope_head_dim": 16, "qk_rope_head_dim": 8,
           "v_head_dim": 16, "moe_intermediate_size": 32, "n_routed_experts": 8,
           "num_experts_per_tok": 2, "n_shared_experts": 1, "q_lora_rank": 32,
           "head_dim": 16, "first_k_dense_replace": 1}
_SHARE_CHIPS = 2


def tiny_config(c: dict) -> dict:
    """``c`` (a configuration as run) cut in place; returns it."""
    c.update((key, value) for key, value in _WIDTHS.items() if c.get(key))
    if c.get("kv_lora_rank"):
        c["num_key_value_heads"] = c["num_attention_heads"]
    for key, share in c.get("share", {}).items():
        share.update(of=c[key], chips=_SHARE_CHIPS)
        c[key] //= _SHARE_CHIPS
    c["bos_token_id"] = 1
    return c


def tiny_cell(name: str, **requests) -> spec.Cell:
    cell = copy.deepcopy(spec.cell(spec.load(), name))
    c = tiny_config(cell.config)
    t = cell.traffic
    if t["kind"] == "pit_train":
        t["plane"].update(docs=16, chunks_per_hour=64, hours=3, chunk_tokens=16)
        t["steps"].update(seq=128)
        t["steps"].update(requests)
        return cell
    t["plane"].update(sessions=4096, events=4096)
    t["requests"].update(pool_batches=16, warmup_batches=1)
    if c.get("n_routed_experts"):  # a routing group is a whole 2k prompt: fewer
        t["requests"]["batch"] = 2
    else:
        t["requests"]["request_tokens"] = min(96, t["requests"]["request_tokens"])
    t["requests"].update(requests)
    t["check"]["sample_positions"] = 256
    return cell
