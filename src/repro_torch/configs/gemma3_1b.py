"""Gemma-3 1B [hf:google/gemma-3-1b-pt]: 5:1 local:global attention, 262k vocab.

26 layers = 4 x (5 local + 1 global) superblocks + 2 trailing local layers.
Sliding window 512.  qk-norm, head_dim 256 (> d_model / n_heads).
"""

from repro_torch.configs.base import ATTN, LayerSpec, ModelConfig

_LOCAL = LayerSpec(ATTN, window=512)
_GLOBAL = LayerSpec(ATTN, window=None)

CONFIG = ModelConfig(
    name="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab_size=262144,
    head_dim=256,
    qk_norm=True,
    rope_theta=1e6,
    tie_embeddings=True,
    act="gelu",
    superblock=(_LOCAL,) * 5 + (_GLOBAL,),
    n_superblocks=4,
    tail=(_LOCAL, _LOCAL),
)
