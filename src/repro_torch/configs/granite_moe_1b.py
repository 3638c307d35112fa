"""IBM Granite-3.0 1B-a400m [hf:ibm-granite/granite-3.0-1b-a400m-base].

32-expert top-8 MoE, expert d_ff=512, GQA kv=8.
"""

from repro_torch.configs.base import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    num_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    ffn_kind="moe",
    n_experts=32,
    top_k=8,
    expert_d_ff=512,
    vocab_size=49155,
    head_dim=64,
    tie_embeddings=True,
    **dense_pattern(24),
)
