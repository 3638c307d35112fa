"""Config registry of the architectures the port runs and the paper's
LLaMA-3 models, and the assigned shape grid (the JAX package's
``configs/__init__.py``, framework-free, so copied rather than imported)."""

from __future__ import annotations

import dataclasses

from repro_torch.configs import (arctic_480b, gemma3_1b, granite_moe_1b, internvl2_76b, llama,
                                 mamba2_13b, qwen2_05b, qwen3_17b, qwen25_14b,
                                 recurrentgemma_9b, seamless_m4t_medium)
from repro_torch.configs.base import (ATTN, LRU, SSM, LayerSpec, ModelConfig,  # noqa: F401
                                      dense_pattern)
from repro_torch.configs.llama import (LLAMA_7B, LLAMA_13B, LLAMA_34B, LLAMA_70B,  # noqa: F401
                                       PAPER_SIZES, critic_of)

ARCHS: dict[str, ModelConfig] = {c.name: c for c in (qwen2_05b.CONFIG,
                                                     qwen3_17b.CONFIG,
                                                     gemma3_1b.CONFIG,
                                                     qwen25_14b.CONFIG,
                                                     granite_moe_1b.CONFIG,
                                                     arctic_480b.CONFIG,
                                                     mamba2_13b.CONFIG,
                                                     recurrentgemma_9b.CONFIG,
                                                     internvl2_76b.CONFIG,
                                                     seamless_m4t_medium.CONFIG,
                                                     *llama.PAPER_SIZES.values())}
ASSIGNED = [
    "internvl2-76b", "qwen2.5-14b", "gemma3-1b", "qwen3-1.7b", "qwen2-0.5b",
    "recurrentgemma-9b", "mamba2-1.3b", "arctic-480b", "granite-moe-1b-a400m",
    "seamless-m4t-medium",
]


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def cell_supported(cfg: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether (arch x shape) is a runnable cell, with a reason when skipped."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "long_500k requires sub-quadratic attention (pure full-attention arch)"
    return True, ""


def all_cells(include_skipped: bool = False):
    """(arch, shape name, supported, reason) over ``ASSIGNED`` x ``SHAPES``;
    the skipped cells too with ``include_skipped``."""
    for a in ASSIGNED:
        cfg = ARCHS[a]
        for s in SHAPES.values():
            ok, why = cell_supported(cfg, s)
            if ok or include_skipped:
                yield a, s.name, ok, why
