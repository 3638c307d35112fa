"""SeamlessM4T-medium backbone [arXiv:2308.11596].

[audio]: encoder-decoder transformer; the speech frontend is a stub: a
batch carries ``prefix_len`` precomputed frame embeddings (``frames``) that
the encoder consumes.  12 encoder + 12 decoder layers (num_layers counts the
decoder stack; decoder layers add cross-attention).  As in the JAX package,
the encoder is built with the decoder's layer pattern, so its depth is
``num_layers``; ``enc_layers`` feeds only the parameter count.
"""

from repro_torch.configs.base import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    num_layers=12,
    enc_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=256206,
    head_dim=64,
    prefix_len=512,
    **dense_pattern(12),
)
