"""gemma-2b [arXiv:2403.08295; hf].

18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000; GeGLU,
head_dim=256, tied embeddings.
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-2b", family="dense",
    num_layers=18, d_model=2048, vocab_size=256_000,
    num_heads=8, num_kv_heads=1, head_dim=256,
    d_ff=16_384, mlp_variant="geglu", tie_embeddings=True,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, d_model=64, vocab_size=512,
        num_heads=4, num_kv_heads=1, head_dim=16, d_ff=128,
    )
