"""deepseek-v3-671b [arXiv:2412.19437; hf].

61L d_model=7168 128H d_ff(expert)=2048 vocab=129280; MLA (q_lora 1536,
kv_lora 512, qk_nope 128 / qk_rope 64 / v 128); MoE 256 routed top-8 +
1 shared; 3 leading dense layers d_ff=18432; MTP depth 1.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    num_layers=61, d_model=7168, vocab_size=129_280,
    num_heads=128, num_kv_heads=128, head_dim=128,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    d_ff=18_432, mlp_variant="swiglu",
    moe=True, num_experts=256, num_shared_experts=1, top_k=8,
    moe_d_ff=2048, first_dense_layers=3,
    mtp_depth=1,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=4, d_model=64, vocab_size=512,
        num_heads=4, num_kv_heads=4, head_dim=16,
        q_lora_rank=32, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
        v_head_dim=16, d_ff=128, num_experts=8, top_k=2,
        num_shared_experts=1, moe_d_ff=32, first_dense_layers=1, mtp_depth=1,
    )
