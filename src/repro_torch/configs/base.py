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

    @property
    def is_subquadratic(self) -> bool:
        """True if the arch can serve 500k-token contexts without a full
        quadratic KV cache on every layer (SSM / hybrid / mostly-local attn)."""
        specs = self.layers
        n_full = sum(1 for s in specs if s.kind == ATTN and s.window is None)
        return n_full <= len(specs) // 4

    # --------------------------------------------------------- param counts
    # The JAX package's counts, read by the cost model (core/estimator.py).
    # The port's configs have no dense residual FFN beside the experts
    # (Arctic's), so ``ffn_params`` has no term for one.
    def attn_params(self, spec: LayerSpec) -> int:
        d, q, kv = self.d_model, self.q_dim, self.kv_dim
        p = d * q + 2 * d * kv + q * d  # wq, wk, wv, wo
        if self.qkv_bias:
            p += q + 2 * kv
        if self.qk_norm:
            p += 2 * self.head_dim
        return p

    def ffn_params(self, active_only: bool = False) -> int:
        d = self.d_model
        if self.ffn_kind == "none":
            return 0
        if self.ffn_kind == "moe":
            per_expert = 3 * d * self.expert_d_ff
            n = self.top_k if active_only else self.n_experts
            return n * per_expert + d * self.n_experts  # experts + router
        return 3 * d * self.d_ff  # gated: w_in, w_gate, w_out

    def lru_params(self) -> int:
        d, w = self.d_model, self.lru_width
        conv = 4 * w  # temporal conv1d width 4
        return 2 * d * w + w * d + conv + 2 * w  # in/gate proj, out proj, a/gate params

    def ssm_params(self) -> int:
        d, di, ds = self.d_model, self.ssm_inner, self.ssm_state
        in_proj = d * (2 * di + 2 * ds + self.ssm_heads)  # x, z, B, C, dt
        conv = self.ssm_conv * (di + 2 * ds)
        out = di * d
        extra = 2 * self.ssm_heads + di  # A_log, D, norm
        return in_proj + conv + out + extra

    def layer_params(self, spec: LayerSpec, active_only: bool = False) -> int:
        norms = 2 * self.d_model
        if spec.kind == ATTN:
            p = self.attn_params(spec)
        elif spec.kind == LRU:
            p = self.lru_params()
        else:
            p = self.ssm_params()
        if spec.has_ffn and self.ffn_kind != "none":
            p += self.ffn_params(active_only) + self.d_model
        return p + norms

    def param_count(self, active_only: bool = False) -> int:
        p = sum(self.layer_params(s, active_only) for s in self.layers)
        p += self.vocab_size * self.d_model  # input embedding
        if not self.tie_embeddings:
            p += self.vocab_size * self.d_model  # lm head
        p += self.d_model  # final norm
        if self.family == "encdec":
            enc_spec = LayerSpec(ATTN, None, True)
            xattn = self.d_model * self.q_dim + 2 * self.d_model * self.kv_dim + \
                self.q_dim * self.d_model + self.d_model
            p += self.enc_layers * self.layer_params(enc_spec, active_only)
            p += self.num_layers * xattn  # decoder cross-attn
            p += self.d_model
        return p

    def active_param_count(self) -> int:
        return self.param_count(active_only=True)

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
