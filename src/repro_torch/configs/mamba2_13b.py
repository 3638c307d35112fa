"""Mamba2-1.3B [arXiv:2405.21060]: pure SSD (state-space duality), attention-free."""

from repro_torch.configs.base import SSM, LayerSpec, ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    ffn_kind="none",
    vocab_size=50280,
    head_dim=0,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=128,
    tie_embeddings=True,
    superblock=(LayerSpec(SSM, has_ffn=False),),
    n_superblocks=48,
)
