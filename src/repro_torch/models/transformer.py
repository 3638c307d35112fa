"""The layer stack: one parameter dict per layer, run by a Python loop (the
JAX package stacks each group's layers and ``lax.scan``s them).

Four execution paths share the parameters:
  * ``stack_apply``        - full-sequence forward
  * ``stack_prefill``      - full-sequence forward that also fills decode caches
  * ``stack_decode``       - single-token step through the caches
  * ``stack_paged_decode`` - single-token step with per-row positions through
                             paged caches (continuous batching)

Attention mixers are ported, with a gated-MLP FFN or a dropless MoE FFN
(``models/moe.py``).  RG-LRU, SSM and cross-attention raise
``NotImplementedError``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ATTN, LayerSpec, ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M


def check_supported(cfg: ModelConfig):
    """Raise for the parts of ``cfg`` this port does not run yet."""
    kinds = {s.kind for s in cfg.layers}
    if kinds != {ATTN}:
        raise NotImplementedError(f"{cfg.name}: mixers {sorted(kinds - {ATTN})} "
                                  "are not ported (attention only)")
    if cfg.ffn_kind not in ("gated", "moe", "none"):
        raise NotImplementedError(f"{cfg.name}: ffn_kind={cfg.ffn_kind!r} is not ported")
    if cfg.family == "encdec" or cfg.prefix_len:
        raise NotImplementedError(f"{cfg.name}: encoder/prefix inputs are not ported")


def block_init(gen, cfg: ModelConfig, spec: LayerSpec, device):
    dt = L.dtype_of(cfg)
    p = {"ln1": L.rmsnorm_init(cfg.d_model, dt, device),
         "mixer": A.attn_init(gen, cfg, device)}
    if spec.has_ffn and cfg.ffn_kind != "none":
        p["ln2"] = L.rmsnorm_init(cfg.d_model, dt, device)
        p["ffn"] = (M.moe_init(gen, cfg, device) if cfg.ffn_kind == "moe"
                    else L.mlp_init(gen, cfg, device))
    return p


def _ffn(p, cfg, x, impl):
    if "ffn" not in p:
        return x
    h = L.rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
    if cfg.ffn_kind == "moe":
        return x + M.moe_apply(p["ffn"], cfg, h, impl=impl)
    return x + L.mlp_apply(p["ffn"], cfg, h)


def block_apply(p, cfg, spec, x, rope, *, impl="cuda"):
    """Full-sequence block.  Returns (x, kv): the layer's roped k/v, for
    prefill caching."""
    h = L.rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    y, kv = A.attn_apply_with_kv(p["mixer"], cfg, spec, h, rope, impl=impl)
    return _ffn(p, cfg, x + y, impl), kv


def block_decode(p, cfg, spec, x, cache, t, rope, cache_len, *, impl="cuda"):
    """Single-token block step; updates ``cache`` in place."""
    h = L.rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    y = A.attn_decode_apply(p["mixer"], cfg, spec, h, cache, t, rope, cache_len,
                            impl=impl)
    return _ffn(p, cfg, x + y, impl)


def block_paged_decode(p, cfg, spec, x, cache, block_table, dest, rope, cache_len,
                       *, impl="cuda"):
    """Single-token block step with per-row positions: full-attention
    layers go through the block pool, window layers through their per-slot
    rings; ``dest`` indexes each row's write into ``cache``.  Updates
    ``cache`` in place."""
    h = L.rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    if spec.window is None:
        y = A.paged_attn_decode_apply(p["mixer"], cfg, h, cache, block_table, dest,
                                      rope, cache_len, impl=impl)
    else:
        y = A.ragged_attn_decode_apply(p["mixer"], cfg, spec, h, cache, dest, rope,
                                       cache_len, impl=impl)
    return _ffn(p, cfg, x + y, impl)


def stack_init(gen, cfg: ModelConfig, device):
    check_supported(cfg)
    return [block_init(gen, cfg, spec, device) for spec in cfg.layers]


def _arange_rope(cfg: ModelConfig, x):
    positions = torch.arange(x.shape[1], device=x.device)
    return L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)


def stack_apply(layers_params, cfg: ModelConfig, x, *, impl="cuda"):
    """Full-sequence forward at positions arange(S)."""
    rope = _arange_rope(cfg, x)
    for p, spec in zip(layers_params, cfg.layers):
        x, _ = block_apply(p, cfg, spec, x, rope, impl=impl)
    return x


def cache_init(cfg: ModelConfig, batch, max_len, dtype, device):
    return [A.cache_init(cfg, spec, batch, max_len, dtype, device)
            for spec in cfg.layers]


def stack_prefill(layers_params, cfg: ModelConfig, x, caches, *, impl="cuda"):
    """Full forward that fills the decode caches (from ``cache_init``) in
    place.  Returns x."""
    rope = _arange_rope(cfg, x)
    seq_len = x.shape[1]
    for p, spec, cache in zip(layers_params, cfg.layers, caches):
        x, kv = block_apply(p, cfg, spec, x, rope, impl=impl)
        A.prefill_into_cache(cache, spec, kv["k"], kv["v"], seq_len)
    return x


def stack_decode(layers_params, cfg: ModelConfig, x, caches, t, *, impl="cuda"):
    """x: (B, 1, D); t: the token's position.  Updates ``caches`` in place
    and returns x.  The RoPE tables and cache lengths of the step are built
    once here, not per layer."""
    rope = L.rope_tables(torch.full((1, 1), t, device=x.device), cfg.head_dim,
                         cfg.rope_theta)
    cache_len = torch.full((x.shape[0],), t + 1, dtype=torch.int32, device=x.device)
    for p, spec, cache in zip(layers_params, cfg.layers, caches):
        x = block_decode(p, cfg, spec, x, cache, t, rope, cache_len, impl=impl)
    return x


def stack_paged_decode(layers_params, cfg: ModelConfig, x, caches, block_table,
                       positions, *, impl="cuda"):
    """x: (B, 1, D); block_table: (B, M) int32; positions: (B,) int32, each
    row's token position.  Updates ``caches`` in place and returns x.  The
    RoPE tables, cache lengths and write indices of the step are built once
    here, not per layer: a pool's (block, offset) pair is shared by every
    full-attention layer, a ring's (row, slot) pair by every window layer
    of its length."""
    rope = L.rope_tables(positions[:, None], cfg.head_dim, cfg.rope_theta)
    cache_len = positions + 1
    rows = torch.arange(x.shape[0], device=x.device)
    dests = {}
    for p, spec, cache in zip(layers_params, cfg.layers, caches):
        # a pool's block size, or a ring's length
        key = (spec.window is None, cache["k"].shape[1])
        if key not in dests:
            paged, n = key
            dests[key] = ((block_table[rows, positions // n], positions % n) if paged
                          else (rows, positions % n))
        x = block_paged_decode(p, cfg, spec, x, cache, block_table, dests[key], rope,
                               cache_len, impl=impl)
    return x
