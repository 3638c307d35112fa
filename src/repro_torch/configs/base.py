"""Model configuration: the port's own copy of the JAX package's
``configs/base.py`` (framework-free, so copied rather than imported).

A model is a sequence of groups: ``superblock`` repeated ``n_superblocks``
times, then an optional ``tail``.  Every layer is one mixer plus an optional
FFN.  The port runs one module per layer (no stacked scan), so a group is
only a way to spell the layer pattern.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

ATTN = "attn"
LRU = "lru"
SSM = "ssm"


@dataclasses.dataclass(frozen=True)
class LayerSpec:
    """One mixer layer inside a superblock."""

    kind: str = ATTN  # attn | lru | ssm
    window: Optional[int] = None  # sliding-window size; None => full causal
    has_ffn: bool = True


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | encdec
    num_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int

    superblock: tuple[LayerSpec, ...]
    n_superblocks: int
    tail: tuple[LayerSpec, ...] = ()

    # FFN flavour
    ffn_kind: str = "gated"  # gated | moe | none
    n_experts: int = 0
    top_k: int = 0
    expert_d_ff: int = 0

    # Attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 1e4
    act: str = "silu"  # silu | gelu

    # Mamba2 / SSD (models/ssm.py)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128

    # RG-LRU (models/rglru.py)
    lru_width: int = 0

    enc_layers: int = 0
    prefix_len: int = 0

    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    dtype: str = "bfloat16"

    def __post_init__(self):
        n = len(self.superblock) * self.n_superblocks + len(self.tail)
        if n != self.num_layers:
            raise ValueError(f"{self.name}: pattern covers {n} layers != "
                             f"num_layers={self.num_layers}")

    @property
    def layers(self) -> list[LayerSpec]:
        return list(self.superblock) * self.n_superblocks + list(self.tail)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim if self.ssm_state else 0

    def reduced(self, **overrides) -> "ModelConfig":
        """A tiny config of the same family for CPU tests (the same
        reduction as the JAX package's ``ModelConfig.reduced``)."""
        n_sb = min(self.n_superblocks, 2)
        kw = dict(
            name=self.name + "-smoke",
            num_layers=len(self.superblock) * n_sb + len(self.tail),
            n_superblocks=n_sb,
            d_model=64,
            n_heads=min(self.n_heads, 4),
            n_kv_heads=max(1, min(self.n_kv_heads, 2)),
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            expert_d_ff=32 if self.expert_d_ff else 0,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            vocab_size=512,
            lru_width=64 if self.lru_width else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=8 if self.ssm_state else 128,
            enc_layers=min(self.enc_layers, 2),
            prefix_len=min(self.prefix_len, 8),
            superblock=tuple(
                dataclasses.replace(s, window=min(s.window, 16) if s.window else None)
                for s in self.superblock),
            tail=tuple(
                dataclasses.replace(s, window=min(s.window, 16) if s.window else None)
                for s in self.tail),
            dtype="float32",  # CPU tests run in fp32
        )
        kw.update(overrides)
        return dataclasses.replace(self, **kw)


def dense_pattern(n: int, window: Optional[int] = None) -> dict:
    return dict(superblock=(LayerSpec(ATTN, window),), n_superblocks=n, tail=())
