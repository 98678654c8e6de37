"""deepseek-v2-lite-16b [arXiv:2405.04434; hf].

27L d_model=2048 16H d_ff(expert)=1408 vocab=102400; MLA kv_lora=512
(qk_nope 128 / qk_rope 64 / v 128, no q-lora on the lite model); MoE 64
routed experts top-6 + 2 shared, leading dense layer d_ff=10944.
(The assignment line also mentions "160 routed" — that is the full-V2
config; we follow the primary spec "64e top-6".  See DESIGN.md §5.)
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    num_layers=27, d_model=2048, vocab_size=102_400,
    num_heads=16, num_kv_heads=16, head_dim=128,
    use_mla=True, q_lora_rank=0, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    d_ff=10_944, mlp_variant="swiglu",
    moe=True, num_experts=64, num_shared_experts=2, top_k=6,
    moe_d_ff=1408, first_dense_layers=1,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=64, vocab_size=512,
        num_heads=4, num_kv_heads=4, head_dim=16,
        kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
        d_ff=128, num_experts=8, top_k=2, num_shared_experts=1,
        moe_d_ff=32, first_dense_layers=1,
    )
