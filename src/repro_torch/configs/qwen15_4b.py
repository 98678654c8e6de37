"""qwen1.5-4b [hf:Qwen/Qwen1.5 family; hf].

40L d_model=2560 20H (MHA kv=20) d_ff=6912 vocab=151936; QKV bias.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    num_layers=40, d_model=2560, vocab_size=151_936,
    num_heads=20, num_kv_heads=20, head_dim=128,
    d_ff=6912, mlp_variant="swiglu", qkv_bias=True,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, vocab_size=512,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128,
    )
