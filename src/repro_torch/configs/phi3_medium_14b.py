"""phi3-medium-14b [arXiv:2404.14219; unverified].

40L d_model=5120 40H (GQA kv=10) d_ff=17920 vocab=100352; RoPE SwiGLU GQA.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi3-medium-14b", family="dense",
    num_layers=40, d_model=5120, vocab_size=100_352,
    num_heads=40, num_kv_heads=10, head_dim=128,
    d_ff=17_920, mlp_variant="swiglu",
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, vocab_size=512,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
    )
