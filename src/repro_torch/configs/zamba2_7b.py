"""zamba2-7b [arXiv:2411.15242; unverified].

81 Mamba2 layers d_model=3584 (ssm_state=64) + ONE shared attention block
(32H, d_ff=14336) applied every 6th layer, vocab=32000.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    num_layers=81, d_model=3584, vocab_size=32_000,
    ssm=True, ssm_state=64, ssm_expand=2, ssm_head_dim=64,
    ssm_groups=1, ssm_conv_width=4, ssm_chunk=256,
    num_heads=32, num_kv_heads=32, head_dim=112,
    d_ff=14_336, mlp_variant="gelu",
    hybrid_attn_period=6,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=7, d_model=64, vocab_size=512,
        ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
        hybrid_attn_period=3,
    )
