"""LLaMA-3 configurations from the paper (Table 1), the models of its RLHF
experiments; the port's copy of the JAX package's ``configs/llama.py``.

Critic and reward variants replace the 128256-way output embedding with a
scalar value head (the paper names a model by its embedding-less parameter
count); ``init_params(..., head="value")`` builds that head.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig, dense_pattern


def _llama(name, layers, d_model, d_ff, heads, kv_heads) -> ModelConfig:
    return ModelConfig(
        name=name,
        family="dense",
        num_layers=layers,
        d_model=d_model,
        n_heads=heads,
        n_kv_heads=kv_heads,
        d_ff=d_ff,
        vocab_size=128256,
        head_dim=d_model // heads,
        rope_theta=5e5,
        **dense_pattern(layers),
    )


LLAMA_7B = _llama("llama-7b", 32, 4096, 14336, 32, 8)
LLAMA_13B = _llama("llama-13b", 40, 5120, 13824, 40, 40)
LLAMA_34B = _llama("llama-34b", 48, 8192, 22016, 64, 8)
LLAMA_70B = _llama("llama-70b", 80, 8192, 28672, 64, 8)


def critic_of(cfg: ModelConfig) -> ModelConfig:
    """The paper's critic: the same trunk, a scalar value head instead of
    the LM head."""
    return dataclasses.replace(cfg, name=cfg.name + "-critic")


PAPER_SIZES = {"7b": LLAMA_7B, "13b": LLAMA_13B, "34b": LLAMA_34B, "70b": LLAMA_70B}
