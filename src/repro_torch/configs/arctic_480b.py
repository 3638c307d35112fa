"""Snowflake Arctic 480B [hf:Snowflake/snowflake-arctic-base].

Dense-MoE hybrid: every layer has a dense residual MLP (d_ff=4864) in
parallel with a 128-expert top-2 MoE (expert d_ff=4864).
"""

from repro_torch.configs.base import ModelConfig, dense_pattern

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    ffn_kind="moe",
    n_experts=128,
    top_k=2,
    expert_d_ff=4864,
    dense_residual_ffn=True,
    vocab_size=32000,
    head_dim=128,
    rope_theta=1e6,
    **dense_pattern(35),
)
