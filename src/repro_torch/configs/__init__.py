"""Config registry of the architectures the port runs so far."""

from __future__ import annotations

from repro_torch.configs import granite_moe_1b, qwen2_05b
from repro_torch.configs.base import ATTN, LayerSpec, ModelConfig, dense_pattern  # noqa: F401

ARCHS: dict[str, ModelConfig] = {c.name: c for c in (qwen2_05b.CONFIG,
                                                     granite_moe_1b.CONFIG)}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
