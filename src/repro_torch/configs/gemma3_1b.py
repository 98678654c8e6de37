"""gemma3-1b [hf:google/gemma-3-1b-pt; unverified].

26L d_model=1152 4H (MQA kv=1, head_dim 256) d_ff=6912 vocab=262144;
5:1 local:global sliding-window attention (window 512), tied embeddings.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b", family="dense",
    num_layers=26, d_model=1152, vocab_size=262_144,
    num_heads=4, num_kv_heads=1, head_dim=256,
    d_ff=6912, mlp_variant="geglu", tie_embeddings=True,
    local_global_period=6, sliding_window=512,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=6, d_model=64, vocab_size=512,
        num_heads=4, num_kv_heads=1, head_dim=16, d_ff=128,
        local_global_period=3, sliding_window=8,
    )
