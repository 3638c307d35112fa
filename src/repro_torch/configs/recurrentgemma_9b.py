"""RecurrentGemma-9B [arXiv:2402.19427]: Griffin, RG-LRU + local attention 2:1.

38 layers = 12 x (lru, lru, local-attn) superblocks + 2 trailing lru layers.
Every block carries a gated MLP.  Sliding window 2048, MQA (kv=1).
"""

from repro_torch.configs.base import ATTN, LRU, LayerSpec, ModelConfig

_LRU = LayerSpec(LRU)
_ATTN = LayerSpec(ATTN, window=2048)

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    lru_width=4096,
    tie_embeddings=True,
    act="gelu",
    superblock=(_LRU, _LRU, _ATTN),
    n_superblocks=12,
    tail=(_LRU, _LRU),
)
