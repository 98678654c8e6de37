"""whisper-tiny [arXiv:2212.04356; unverified].

Enc-dec backbone: 4+4L d_model=384 6H d_ff=1536 vocab=51865; the conv/mel
frontend is a STUB — input_specs() supplies precomputed frame embeddings
(B, 1500, 384).  decode_32k is lowered structurally even though the
published model decodes at 448 (DESIGN.md §5).
"""
import dataclasses
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny", family="audio",
    num_layers=4, d_model=384, vocab_size=51_865,
    num_heads=6, num_kv_heads=6, head_dim=64,
    d_ff=1536, mlp_variant="gelu", tie_embeddings=True,
    encoder_decoder=True, encoder_layers=4, encoder_seq=1500,
)

def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, num_layers=2, encoder_layers=2, d_model=64, vocab_size=512,
        num_heads=4, num_kv_heads=4, head_dim=16, d_ff=128, encoder_seq=32,
    )
