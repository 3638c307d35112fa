"""Config registry of the architectures the port runs so far."""

from __future__ import annotations

from repro_torch.configs import granite_moe_1b, mamba2_13b, qwen2_05b, recurrentgemma_9b
from repro_torch.configs.base import (ATTN, LRU, SSM, LayerSpec, ModelConfig,  # noqa: F401
                                      dense_pattern)

ARCHS: dict[str, ModelConfig] = {c.name: c for c in (qwen2_05b.CONFIG,
                                                     granite_moe_1b.CONFIG,
                                                     mamba2_13b.CONFIG,
                                                     recurrentgemma_9b.CONFIG)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
