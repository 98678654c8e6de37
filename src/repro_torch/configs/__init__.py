"""Architecture config registry: ``get_config(arch_id)`` / ``--arch <id>``."""
from __future__ import annotations

from repro_torch.models.config import ModelConfig

_MODULES = {
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "phi3-medium-14b": "phi3_medium_14b",
    "gemma-2b": "gemma_2b",
    "qwen1.5-4b": "qwen15_4b",
    "gemma3-1b": "gemma3_1b",
    "zamba2-7b": "zamba2_7b",
    "pixtral-12b": "pixtral_12b",
    "whisper-tiny": "whisper_tiny",
    "mamba2-2.7b": "mamba2_27b",
}


def get_config(arch: str, *, reduced: bool = False) -> ModelConfig:
    import importlib

    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.reduced() if reduced else mod.CONFIG


def list_archs() -> list[str]:
    return sorted(_MODULES)
