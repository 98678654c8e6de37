"""pixtral-12b [hf:mistralai/Pixtral-12B-2409; unverified].

Backbone only (mistral-nemo): 40L d_model=5120 32H (GQA kv=8, head_dim
128) d_ff=14336 vocab=131072.  The pixtral-ViT frontend is a STUB:
input_specs() supplies precomputed patch embeddings (vision_dim=1024),
projected and prepended to the token sequence.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    num_layers=40, d_model=5120, vocab_size=131_072,
    num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14_336, mlp_variant="swiglu", rope_theta=1e6,
    vision_prefix=True, vision_dim=1024, num_patches=1024,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, vocab_size=512,
        num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
        vision_dim=32, num_patches=8,
    )
