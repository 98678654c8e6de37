"""What a configuration file may state, and how the harness takes it:
every published key accounted for, ``run.port``, a query LoRA, a chip's
share of a deployment and extra leaves."""

import copy
import dataclasses
from fractions import Fraction

import pytest
import torch

from fsbench import flops, spec, weights
from fsbench.tiny import tiny_config

# DeepSeek-V3's published config.json (huggingface.co/deepseek-ai/DeepSeek-V3), as run
# with the harness's own keys; no `run`, `port_reads` or share yet.
V3 = {
    "name": "deepseek-v3-671b", "source": "https://huggingface.co/deepseek-ai/DeepSeek-V3",
    "reference": "reference_lm", "reduced": {}, "assumed": {},
    "attention_bias": False, "ep_size": 1, "first_k_dense_replace": 3, "hidden_act": "silu",
    "hidden_size": 7168, "intermediate_size": 18432, "kv_lora_rank": 512,
    "max_position_embeddings": 163840, "model_type": "deepseek_v3",
    "moe_intermediate_size": 2048, "moe_layer_freq": 1, "n_group": 8,
    "n_routed_experts": 256, "n_shared_experts": 1, "norm_topk_prob": True,
    "num_attention_heads": 128, "num_experts_per_tok": 8, "num_hidden_layers": 61,
    "num_key_value_heads": 128, "num_nextn_predict_layers": 1, "q_lora_rank": 1536,
    "qk_nope_head_dim": 128, "qk_rope_head_dim": 64, "rms_norm_eps": 1e-06,
    "rope_scaling": {"beta_fast": 32, "beta_slow": 1, "factor": 40, "mscale": 1,
                     "mscale_all_dim": 1, "original_max_position_embeddings": 4096,
                     "type": "yarn"},
    "rope_theta": 10000, "routed_scaling_factor": 2.5, "scoring_func": "sigmoid",
    "tie_word_embeddings": False, "topk_group": 4, "topk_method": "noaux_tc",
    "v_head_dim": 128, "vocab_size": 129280, "torch_dtype": "bfloat16"}
V3_FORWARD = ["n_group", "num_nextn_predict_layers", "rope_scaling", "routed_scaling_factor",
              "scoring_func", "topk_group", "topk_method"]
# The share of one GPU of the report's prefill unit (arXiv:2412.19437, section 3.4.1):
# attention on TP4, the routed experts on EP32.
SHARE = {"n_routed_experts": {"of": 256, "chips": 32},
         "num_attention_heads": {"of": 128, "chips": 4},
         "num_key_value_heads": {"of": 128, "chips": 4}}


def _told(c: dict, port: dict) -> dict:
    """``c`` with its forward keys read by the port and a ``run.port``."""
    c = copy.deepcopy(c)
    c["port_reads"] = [k for k in V3_FORWARD if k in c]
    c["run"] = {"port": port}
    c["assumed"] = {k: "read by the port" for k in c["port_reads"] + ["port"]}
    return spec.as_run(c)


def _held(c: dict) -> dict:
    c = copy.deepcopy(c)
    c["share"] = copy.deepcopy(SHARE)
    for k, s in SHARE.items():
        c[k] = s["of"] // s["chips"]
    return c


def _lite() -> dict:
    return spec.cell(spec.load(), "deepseek-v2-lite-16b.prefill-2k").config


def test_v3_untold_raises_naming_each_forward_key():
    with pytest.raises(ValueError) as e:
        spec.model_config(V3)
    for k in V3_FORWARD:
        assert k in str(e.value)


@pytest.mark.parametrize("key,value", [
    ("scoring_func", "sigmoid"), ("n_group", 8), ("topk_group", 4),
    ("routed_scaling_factor", 2.5), ("topk_method", "noaux_tc"),
    ("rope_scaling", {"type": "yarn", "factor": 40}), ("layer_types", ["full_attention"]),
    ("index_topk", 2048), ("norm_topk_prob", False)])
def test_a_key_the_harness_would_drop_raises(key, value):
    c = _lite()
    spec.model_config(c)
    c[key] = value
    with pytest.raises(ValueError, match=key):
        spec.model_config(c)


def test_v3_told_maps_with_run_port():
    c = _told(V3, {"capacity_factor": 1.0, "attn_impl": "xla"})
    cfg = spec.model_config(c)
    assert (cfg.capacity_factor, cfg.attn_impl, cfg.q_lora_rank, cfg.num_experts) == (
        1.0, "xla", 1536, 256)
    assert cfg.head_dim == 7168 // 128


def test_run_port_field_the_port_lacks_raises():
    with pytest.raises(ValueError, match="scoring"):
        spec.model_config(_told(V3, {"scoring": "sigmoid"}))


def test_run_and_port_reads_need_reasons():
    c = _told(V3, {"attn_impl": "xla"})
    del c["assumed"]["scoring_func"]
    with pytest.raises(ValueError, match="scoring_func"):
        spec.model_config(c)
    c = _lite()
    c["port_reads"] = ["seq_aux", "no_such_key"]
    c["assumed"]["no_such_key"] = "a stale entry"
    with pytest.raises(ValueError, match="no_such_key"):
        spec.model_config(c)


def test_head_dim_from_the_file_reaches_mapping_leaves_and_flops():
    c = copy.deepcopy(spec.cell(spec.load(), "phi3-medium-14b.prefill-2k").config)
    c["head_dim"] = 96
    assert spec.model_config(c).head_dim == 96
    leaves = {n: shape for n, shape, _, _ in weights.groups(c)[1]}
    assert leaves["tail.0.mixer.wq"] == (5120, 40 * 96)
    assert leaves["tail.0.mixer.wk"] == (5120, 10 * 96)
    assert flops.head_dims(c) == (96, 96)
    assert flops.attention_params(c) == 2 * 5120 * 40 * 96 + 2 * 5120 * 10 * 96
    ops = 4 * 4 * 40 * 96 * flops.causal_pairs(2048)
    assert flops.flash_fwd_bound_s(c, 4, 2048) >= ops / flops.peaks.BF16_FLOPS


def _v3_reduced() -> dict:
    """A query-LoRA configuration at the port's ``deepseek_v3_671b.reduced()``
    widths, in the file's keys."""
    from repro_torch.configs.deepseek_v3_671b import reduced

    r = reduced()
    c = _told(V3, {"capacity_factor": 1.25, "attn_impl": "xla"})
    c.update(name=r.name, num_hidden_layers=r.num_layers, hidden_size=r.d_model,
             vocab_size=r.vocab_size, num_attention_heads=r.num_heads,
             num_key_value_heads=r.num_kv_heads, q_lora_rank=r.q_lora_rank,
             kv_lora_rank=r.kv_lora_rank, qk_nope_head_dim=r.qk_nope_dim,
             qk_rope_head_dim=r.qk_rope_dim, v_head_dim=r.v_head_dim,
             intermediate_size=r.d_ff, n_routed_experts=r.num_experts,
             num_experts_per_tok=r.top_k, n_shared_experts=r.num_shared_experts,
             moe_intermediate_size=r.moe_d_ff, first_k_dense_replace=r.first_dense_layers)
    return c


def test_query_lora_leaves_are_the_ports_parameters():
    from repro_torch.configs.deepseek_v3_671b import reduced
    from repro_torch.models import lm

    c = _v3_reduced()
    cfg = spec.model_config(c)
    widths = ("num_layers", "d_model", "vocab_size", "num_heads", "q_lora_rank",
              "kv_lora_rank", "qk_nope_dim", "qk_rope_dim", "v_head_dim", "d_ff",
              "num_experts", "top_k", "num_shared_experts", "moe_d_ff", "first_dense_layers")
    assert {k: getattr(cfg, k) for k in widths} == {
        k: getattr(reduced(), k) for k in widths}
    want = {n: tuple(p.shape) for n, p in lm.LM(cfg, None, device="meta").named_parameters()}
    got = {n: shape for g in weights.groups(c) for n, shape, _, _ in g}
    assert got == want and "tail.0.mixer.wq_b" in got
    model = lm.LM(cfg, None, device="cpu")
    weights.load(model, c, 2**31 + 5, "cpu")  # raises on a leaf drawn or left over
    q_norm = dict(model.named_parameters())["prefix.0.mixer.q_norm"]
    assert not q_norm.any()


def test_share_draws_held_stacks_and_a_published_router():
    c = _held(_told(V3, {"attn_impl": "xla"}))
    leaves = {n: shape for g in weights.groups(c) for n, shape, _, _ in g}
    assert leaves["tail.0.ffn.router"] == (7168, 256)
    assert leaves["tail.0.ffn.w_gate"] == (8, 7168, 2048)
    assert leaves["tail.0.ffn.w_down"] == (8, 2048, 7168)
    assert leaves["tail.0.mixer.wq_b"] == (1536, 32 * 192)
    assert leaves["tail.0.mixer.wo"] == (32 * 128, 7168)
    assert flops.routed_per_token(c) == Fraction(1, 4)
    per = 3 * 7168 * 2048
    assert flops.ffn_params(c, 3) == 7168 * 256 + (Fraction(1, 4) + 1) * per
    assert flops.ffn_params(c, 0) == 3 * 7168 * 18432
    assert flops.routed_per_token(_lite()) == 6


def test_share_at_full_width_is_one_gpus_share():
    """29,577,379,840 bf16 parameters (norms aside) and 58 float32 routers of
    7,168 x 256: 59.6 GB."""
    c = _held(_told(V3, {"attn_impl": "xla"}))
    leaves = [leaf for g in weights.groups(c) for leaf in g]
    bf16 = sum(torch.Size(shape).numel() for _, shape, _, kind in leaves if kind == "bf16")
    routers = [shape for _, shape, _, kind in leaves if kind == "fp32"]
    assert bf16 == 29_577_379_840
    assert routers == [(7168, 256)] * 58
    assert 2 * bf16 + 4 * 58 * 7168 * 256 == pytest.approx(59.6e9, rel=1e-3)


def test_share_that_does_not_add_up_raises():
    c = _held(_told(V3, {"attn_impl": "xla"}))
    c["share"]["n_routed_experts"]["chips"] = 16
    with pytest.raises(ValueError, match="share.n_routed_experts"):
        spec.model_config(c)


def test_tiny_cuts_query_lora_and_share():
    c = tiny_config(_held(_told(V3, {"attn_impl": "xla"})))
    assert (c["q_lora_rank"], c["n_routed_experts"], c["num_attention_heads"]) == (32, 4, 2)
    assert c["share"]["n_routed_experts"] == {"of": 8, "chips": 2}
    assert c["share"]["num_attention_heads"] == {"of": 4, "chips": 2}
    leaves = {n: shape for g in weights.groups(c) for n, shape, _, _ in g}
    assert leaves["tail.0.ffn.router"] == (64, 8)
    assert leaves["tail.0.ffn.w_up"] == (4, 64, 32)
    assert leaves["tail.0.mixer.wq_b"] == (32, 2 * 24)
    assert flops.routed_per_token(c) == 1
    spec.model_config(c)
    out = weights.draw(c, 7, 2, "cpu")
    assert out["tail.0.ffn.router"].dtype == torch.float32


def test_extra_leaves_come_after_their_layers_own():
    c = tiny_config(_lite())
    c["extra_leaves"] = {"moe": [["ffn.bias", [8], 0, "zero"]],
                         "all": [["mixer.gate", [64, 16], 64, "bf16"]]}
    plain = weights.groups(tiny_config(_lite()))
    got = weights.groups(c)
    assert [leaf[0] for leaf in got[1]] == [leaf[0] for leaf in plain[1]] + [
        "prefix.0.mixer.gate"]
    assert [leaf[0] for leaf in got[2]] == [leaf[0] for leaf in plain[2]] + [
        "tail.0.mixer.gate", "tail.0.ffn.bias"]
    drawn = weights.draw(c, 11, 2, "cpu")
    before = weights.draw(tiny_config(_lite()), 11, 2, "cpu")
    assert all(torch.equal(drawn[n], t) for n, t in before.items())
    assert drawn["tail.0.mixer.gate"].shape == (64, 16) and not drawn["tail.0.ffn.bias"].any()


@pytest.mark.parametrize("bad", [
    {"moe": [["ffn.bias", [64], 0, "fp16"]]}, {"every": [["ffn.bias", [64], 0, "zero"]]},
    {"moe": [["ffn.bias", [64], 3, "zero"]]}, {"moe": [["ffn.router", [2048, 64], 2048, "fp32"]]}])
def test_extra_leaves_malformed_raise(bad):
    c = _lite()
    c["extra_leaves"] = bad
    with pytest.raises(ValueError):
        weights.groups(c)


def test_no_share_counts_stay_integers():
    for w in spec.load()["workloads"]:
        c = spec.cell(spec.load(), w["name"]).config
        assert type(flops.matmul_params(c)) is int
        assert dataclasses.asdict(spec.model_config(c))["head_dim"] == 128


def test_port_only_under_run():
    c = _told(V3, {"attn_impl": "xla"})
    del c["run"]
    with pytest.raises(ValueError, match="port"):
        spec.model_config(c)


def test_head_share_keeps_the_published_head_dim():
    c = copy.deepcopy(spec.cell(spec.load(), "phi3-medium-14b.prefill-2k").config)
    c.update(num_attention_heads=20, num_key_value_heads=5,
             share={"num_attention_heads": {"of": 40, "chips": 2},
                    "num_key_value_heads": {"of": 10, "chips": 2}})
    assert spec.model_config(c).head_dim == 128 == flops.head_dims(c)[0]
    leaves = {n: shape for n, shape, _, _ in weights.groups(c)[1]}
    assert leaves["tail.0.mixer.wq"] == (5120, 20 * 128)
    assert leaves["tail.0.mixer.wv"] == (5120, 5 * 128)
