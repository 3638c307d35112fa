"""Config registry of the architectures the port runs, and the paper's
LLaMA-3 models."""

from __future__ import annotations

from repro_torch.configs import (gemma3_1b, granite_moe_1b, internvl2_76b, llama, mamba2_13b,
                                 qwen2_05b, qwen3_17b, qwen25_14b, recurrentgemma_9b,
                                 seamless_m4t_medium)
from repro_torch.configs.base import (ATTN, LRU, SSM, LayerSpec, ModelConfig,  # noqa: F401
                                      dense_pattern)
from repro_torch.configs.llama import (LLAMA_7B, LLAMA_13B, LLAMA_34B, LLAMA_70B,  # noqa: F401
                                       PAPER_SIZES, critic_of)

ARCHS: dict[str, ModelConfig] = {c.name: c for c in (qwen2_05b.CONFIG,
                                                     qwen3_17b.CONFIG,
                                                     gemma3_1b.CONFIG,
                                                     qwen25_14b.CONFIG,
                                                     granite_moe_1b.CONFIG,
                                                     mamba2_13b.CONFIG,
                                                     recurrentgemma_9b.CONFIG,
                                                     internvl2_76b.CONFIG,
                                                     seamless_m4t_medium.CONFIG,
                                                     *llama.PAPER_SIZES.values())}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
