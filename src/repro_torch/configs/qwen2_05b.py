"""Qwen2-0.5B [arXiv:2407.10671]: GQA kv=2, QKV bias, tied embeddings."""

from repro_torch.configs.base import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    n_heads=14,
    n_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    head_dim=64,
    qkv_bias=True,
    rope_theta=1e6,
    tie_embeddings=True,
    **dense_pattern(24),
)
