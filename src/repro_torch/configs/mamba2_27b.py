"""mamba2-2.7b [arXiv:2405.21060; unverified].

64L d_model=2560, attention-free SSD (state-space duality), ssm_state=128,
expand 2 (d_inner 5120, 80 heads of dim 64), vocab=50280.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    num_layers=64, d_model=2560, vocab_size=50_280,
    ssm=True, ssm_state=128, ssm_expand=2, ssm_head_dim=64,
    ssm_groups=1, ssm_conv_width=4, ssm_chunk=256,
    d_ff=0,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=3, d_model=64, vocab_size=512,
        ssm_state=16, ssm_head_dim=16, ssm_chunk=8,
    )
