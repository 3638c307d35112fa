"""Config registry of the architectures the port runs so far."""

from __future__ import annotations

from repro_torch.configs import qwen2_05b
from repro_torch.configs.base import ATTN, LayerSpec, ModelConfig, dense_pattern  # noqa: F401

ARCHS: dict[str, ModelConfig] = {qwen2_05b.CONFIG.name: qwen2_05b.CONFIG}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
