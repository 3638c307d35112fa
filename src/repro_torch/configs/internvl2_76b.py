"""InternVL2-76B backbone (InternLM2-76B decoder) [arXiv:2404.16821].

[vlm]: the InternViT frontend is a stub: a batch carries ``prefix_len``
precomputed patch embeddings per sequence (``prefix_embeds``), spliced over
the first ``prefix_len`` token positions.
"""

from repro_torch.configs.base import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="dense",
    num_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab_size=128256,
    head_dim=128,
    rope_theta=1e6,
    prefix_len=256,
    **dense_pattern(80),
)
