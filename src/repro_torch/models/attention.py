"""GQA self-attention (QKV bias, qk-norm, RoPE, sliding window) and its KV
caches.

The dense cache is a dict per layer:
  full   : k/v of shape (B, S_max, Hkv, Dh), linear writes at position t
  window : k/v of shape (B, W, Hkv, Dh), ring-buffer writes at t % W
The paged cache (``models/paged_cache.py``) replaces the full-layer buffers
by a shared block pool (N, bs, Hkv, Dh) read through a block table, and
rows decode at their own positions (continuous batching).
RoPE is applied before caching, so ring-slot order is irrelevant.  Unlike
the JAX package, caches are updated in place (one buffer per layer for the
whole generation instead of a new one per step).

Full-sequence attention runs at positions arange(S), so the attention
kernel takes its arange fast path (tile skipping); packed attention
(``attn_apply``) runs at each sequence's own positions through the varlen
kernel.  ``rope`` is the ``layers.rope_tables`` pair of the positions,
built once per step by the layer stack.

An encoder-decoder model's encoder runs ``attn_apply_with_kv`` with
``causal=False``; its decoder layers add cross-attention
(``cross_attn_apply``): queries from the decoder, keys and values from the
encoder output, no RoPE and no mask, so the kernel runs non-causal at
Sq != Skv (Sq the prompt in prefill, 1 in decode).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L


def attn_init(gen, cfg: ModelConfig, device, cross: bool = False):
    """A self-attention layer's weights, or with ``cross`` a decoder's
    cross-attention (no q/k norm, as in the JAX package, even where the
    config has qk-norm)."""
    dt = L.dtype_of(cfg)
    p = {
        "wq": L.dense_init(gen, cfg.d_model, cfg.q_dim, dt, device, cfg.qkv_bias),
        "wk": L.dense_init(gen, cfg.d_model, cfg.kv_dim, dt, device, cfg.qkv_bias),
        "wv": L.dense_init(gen, cfg.d_model, cfg.kv_dim, dt, device, cfg.qkv_bias),
        "wo": L.dense_init(gen, cfg.q_dim, cfg.d_model, dt, device),
    }
    if cfg.qk_norm and not cross:
        p["q_norm"] = L.rmsnorm_init(cfg.head_dim, dt, device)
        p["k_norm"] = L.rmsnorm_init(cfg.head_dim, dt, device)
    return p


def _project_qkv(p, cfg: ModelConfig, x, rope):
    """Roped q (B, S, Hq, Dh) and k, v (B, S, Hkv, Dh) of x (B, S, D)."""
    b, s, _ = x.shape
    q = L.dense_apply(p["wq"], x).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = L.dense_apply(p["wk"], x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = L.dense_apply(p["wv"], x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if "q_norm" in p:
        q = L.rmsnorm_apply(p["q_norm"], q, cfg.norm_eps)
        k = L.rmsnorm_apply(p["k_norm"], k, cfg.norm_eps)
    return L.rope_apply(q, rope), L.rope_apply(k, rope), v


def _out_proj(p, out, partial, cols=None):
    """The output projection; with ``partial`` a tensor-parallel rank's fp32
    share of it (``layers.partial_apply``), for the caller's all-reduce, or
    a whole layer's fp32 output on a rank that holds all of wo (the tensor
    axis does not divide q_dim: ``transformer.layer_plan``), cast once by
    the caller; with ``cols`` (a rank that computed every head for its
    share of wo's rows) only the output's columns that its ``wo`` rows
    take."""
    if cols is not None:
        out = out[..., cols]
    return L.partial_apply(p["wo"], out) if partial else L.dense_apply(p["wo"], out)


def _group(k, kv_head):
    """The KV head ``kv_head`` of k (B, S, Hkv, Dh) as a contiguous (B, S,
    1, Dh), or k itself where ``kv_head`` is None."""
    return k if kv_head is None else k[:, :, kv_head:kv_head + 1].contiguous()


def attn_apply_with_kv(p, cfg: ModelConfig, spec: LayerSpec, x, rope, *,
                       causal=True, impl="cuda", partial=False, kv_head=None, cols=None):
    """Full-sequence attention (training forward / prefill; an encoder's
    with ``causal=False``).  Returns the output and the roped k/v (for
    prefill caching).  Under tensor parallelism ``cfg`` has the rank's
    local heads and ``partial`` is set; with ``kv_head`` (KV projections
    replicated over the tensor axis) ``p`` holds every KV head, the k/v
    returned are all of them, and the rank's query heads, which fall
    within one KV group, attend that group's head.  With ``cols`` (a
    tensor axis that splits a head) ``cfg`` and ``p`` hold every head and
    the rank's ``wo`` rows take those columns of the output."""
    q, k, v = _project_qkv(p, cfg, x, rope)
    out = ops.mha(q, _group(k, kv_head), _group(v, kv_head), causal=causal, window=spec.window,
                  impl=impl)
    y = _out_proj(p, out.reshape(*x.shape[:2], cfg.q_dim), partial, cols)
    return y, {"k": k, "v": v}


def attn_apply(p, cfg: ModelConfig, spec: LayerSpec, x, rope, cu_seqlens, *,
               max_seqlen=None, impl="cuda", partial=False, kv_head=None, cols=None):
    """Causal attention over a packed cohort (the training forward of
    packed PPO).  x is the (1, T, D) cohort, ``rope`` the tables of its
    within-sequence positions (RoPE restarts per sequence), and attention
    is block-diagonal over the ``cu_seqlens`` segments through
    ``ops.varlen_mha``, which is differentiable on both tiers.
    ``partial``, ``kv_head`` and ``cols`` as ``attn_apply_with_kv``'s: a
    tensor-parallel rank's heads and its fp32 share of the wo product."""
    if x.shape[0] != 1:
        raise ValueError(f"a packed cohort must be (1, T, D); got {tuple(x.shape)}")
    q, k, v = _project_qkv(p, cfg, x, rope)
    out = ops.varlen_mha(q[0], _group(k, kv_head)[0], _group(v, kv_head)[0], cu_seqlens,
                         causal=True, window=spec.window, max_seqlen=max_seqlen,
                         impl=impl)[None]
    return _out_proj(p, out.reshape(*x.shape[:2], cfg.q_dim), partial, cols)


def encode_cross_kv(p, cfg: ModelConfig, enc_out):
    """The cross-attention's k/v (B, Skv, Hkv, Dh) of the encoder output
    (B, Skv, D): no RoPE.  Under tensor parallelism ``cfg`` has the rank's
    KV heads, and ``p`` their wk/wv columns (every head's where they are
    replicated over the tensor axis)."""
    b, skv, _ = enc_out.shape
    k = L.dense_apply(p["wk"], enc_out).reshape(b, skv, cfg.n_kv_heads, cfg.head_dim)
    v = L.dense_apply(p["wv"], enc_out).reshape(b, skv, cfg.n_kv_heads, cfg.head_dim)
    return {"k": k, "v": v}


def cross_attn_apply(p, cfg: ModelConfig, x, enc_out=None, enc_kv=None, *, impl="cuda",
                     partial=False, kv_head=None, cols=None):
    """Decoder cross-attention of x (B, Sq, D) over the encoder: its k/v
    from ``enc_out`` or, in prefill and decode, the ``enc_kv`` computed
    once per layer.  No RoPE and no mask (positions play no part).
    ``partial``, ``kv_head`` and ``cols`` as ``attn_apply_with_kv``'s: a
    rank's query heads from its wq columns (or every head, and its
    columns of the output), its fp32 share of the wo product."""
    b, sq, _ = x.shape
    q = L.dense_apply(p["wq"], x).reshape(b, sq, cfg.n_heads, cfg.head_dim)
    if enc_kv is None:
        enc_kv = encode_cross_kv(p, cfg, enc_out)
    out = ops.mha(q, _group(enc_kv["k"], kv_head), _group(enc_kv["v"], kv_head), causal=False,
                  window=None, impl=impl)
    return _out_proj(p, out.reshape(b, sq, cfg.q_dim), partial, cols)


# ------------------------------------------------------------------ KV cache

def cache_cap(spec: LayerSpec, max_len: int) -> int:
    """The slots of a layer's cache: its window (a ring), else max_len."""
    return min(spec.window, max_len) if spec.window else max_len


def cache_init(cfg: ModelConfig, spec: LayerSpec, batch, max_len, dtype, device, slots=None):
    """A layer's k/v buffers; with ``slots`` (a ``parallel/ctx.Slots``)
    only that block of its slots, as a rank of a cache split by slot holds
    them."""
    cap = cache_cap(spec, max_len) if slots is None else slots.stop - slots.start
    shape = (batch, cap, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def prefill_into_cache(cache, spec: LayerSpec, k, v, seq_len: int, slots=None):
    """Write a prefill's roped k/v into the cache in place (ring for
    window layers: only the last ``cap`` tokens, at slot t % cap).  With
    ``slots`` the cache holds that block of the slots, and only the tokens
    whose slot falls in it are written."""
    if slots is None:
        cap, start, stop = cache["k"].shape[1], 0, cache["k"].shape[1]
    else:
        cap, start, stop = slots.cap, slots.start, slots.stop
    if seq_len <= cap:
        hi = min(stop, seq_len)
        if hi > start:
            cache["k"][:, :hi - start] = k[:, start:hi]
            cache["v"][:, :hi - start] = v[:, start:hi]
        return cache
    pos = torch.arange(seq_len - cap, seq_len, device=k.device)
    if slots is not None:
        pos = pos[(pos % cap >= start) & (pos % cap < stop)]
    cache["k"][:, pos % cap - start] = k[:, pos].to(cache["k"].dtype)
    cache["v"][:, pos % cap - start] = v[:, pos].to(cache["v"].dtype)
    return cache


def _write_token(cache, spec: LayerSpec, k, v, t: int, slots=None):
    """Write the token at position t's k/v (B, 1, Hkv, Dh) into its slot in
    place: the ring slot t % cap for window layers; a linear write past the
    end clamps to the last slot, as the JAX package's dynamic_update_slice
    does.  With ``slots`` only the rank whose block holds the slot writes."""
    cap = cache["k"].shape[1] if slots is None else slots.cap
    slot = t % cap if spec.window else min(t, cap - 1)
    if slots is not None:
        slot = slots.local(slot)
        if slot is None:
            return
    cache["k"][:, slot] = k[:, 0]
    cache["v"][:, slot] = v[:, 0]


def attn_decode_apply(p, cfg: ModelConfig, spec: LayerSpec, x, cache, t: int,
                      rope, cache_len, *, impl="cuda", partial=False):
    """One-token decode.  x: (B, 1, D); t: the token's position; rope: the
    tables of position t; cache_len: (B,) int32, all t + 1.  Writes the
    token's k/v into the cache in place and returns the output (with
    ``partial`` a tensor-parallel rank's fp32 share of it, its own query
    and KV heads; a cache split by slot decodes through
    ``attn_decode_partial``)."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x, rope)
    _write_token(cache, spec, k, v, t)
    out = ops.decode_mha(q[:, 0], cache["k"], cache["v"], cache_len=cache_len,
                         window=spec.window, impl=impl)
    return _out_proj(p, out.reshape(b, 1, cfg.q_dim).to(x.dtype), partial)


def attn_decode_partial(p, cfg: ModelConfig, spec: LayerSpec, x, cache, t: int, rope, slots,
                        *, impl="cuda"):
    """One-token decode on a rank that holds the block ``slots`` of a
    cache split by slot: the token's k/v written where the block holds its
    slot, then its query heads attend the block's valid slots (a ring's
    block too, with no window: its valid slots are a prefix).  Returns
    (out (B, Hq, Dh) fp32, lse (B, Hq) fp32) for ``lse_merge``; a block with
    no slot at all attends nothing (out 0, lse -inf)."""
    q, k, v = _project_qkv(p, cfg, x, rope)
    _write_token(cache, spec, k, v, t, slots)
    b, hq, dh = q.shape[0], q.shape[2], q.shape[3]
    if slots.stop == slots.start:
        return (torch.zeros((b, hq, dh), dtype=torch.float32, device=x.device),
                torch.full((b, hq), -torch.inf, device=x.device))
    lens = torch.full((b,), slots.length(t), dtype=torch.int32, device=x.device)
    return ops.decode_mha(q[:, 0], cache["k"], cache["v"], cache_len=lens, return_lse=True,
                          impl=impl)


def decode_out(p, cfg: ModelConfig, out, dtype, *, cols=None):
    """A rank's fp32 share of the output projection of the merged
    attention rows ``out`` (B, Hq, Dh) fp32, cast once to ``dtype``; with
    ``cols`` the columns its ``wo`` rows take."""
    return _out_proj(p, out.reshape(out.shape[0], 1, cfg.q_dim).to(dtype), True, cols)


def paged_attn_decode_apply(p, cfg: ModelConfig, x, cache, block_table, dest,
                            rope, cache_len, *, impl="cuda"):
    """One-token decode through a paged block-pool KV cache, rows at their
    own positions.  x: (B, 1, D); cache: {"k"/"v": (N, bs, Hkv, Dh)};
    block_table: (B, M) int32; dest: the (block, offset) index pair of each
    row's write, (block_table[b, pos // bs], pos % bs); rope: the tables of
    the rows' positions; cache_len: positions + 1.  Writes each row's k/v
    at ``dest`` in place and returns the output."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x, rope)
    cache["k"][dest] = k[:, 0]
    cache["v"][dest] = v[:, 0]
    out = ops.paged_decode_mha(q[:, 0], cache["k"], cache["v"], block_table,
                               cache_len=cache_len, impl=impl)
    return L.dense_apply(p["wo"], out.reshape(b, 1, cfg.q_dim).to(x.dtype))


def ragged_attn_decode_apply(p, cfg: ModelConfig, spec: LayerSpec, x, cache, dest,
                             rope, cache_len, *, impl="cuda"):
    """``attn_decode_apply`` for a sliding-window ring with per-row
    positions.  dest: the (row, slot) index pair of each row's write,
    (b, positions[b] % W).  Full-attention layers go through
    ``paged_attn_decode_apply`` instead."""
    if spec.window is None:
        raise ValueError("ragged decode is ring-cache only; use paged_attn_decode_apply")
    b = x.shape[0]
    q, k, v = _project_qkv(p, cfg, x, rope)
    cache["k"][dest] = k[:, 0]
    cache["v"][dest] = v[:, 0]
    out = ops.decode_mha(q[:, 0], cache["k"], cache["v"], cache_len=cache_len,
                         window=spec.window, impl=impl)
    return L.dense_apply(p["wo"], out.reshape(b, 1, cfg.q_dim).to(x.dtype))


def paged_attn_verify_apply(p, cfg: ModelConfig, x, cache, block_table, dest, rope,
                            positions, *, impl="cuda"):
    """Multi-token (speculative verify) step through the paged block pool.
    x: (B, K, D), the spec window (the last committed token, then the draft
    tokens); positions: (B, K) int32, consecutive per row; dest: the
    (block, offset) index pair of each token's write, each (B, K); rope:
    the tables of ``positions``.  All K tokens' roped k/v go into the pool
    first (a row's consecutive positions never share a slot), then query j
    attends every logical position <= positions[b, j]."""
    b, kk, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, rope)
    cache["k"][dest] = k
    cache["v"][dest] = v
    out = ops.paged_verify_mha(q, cache["k"], cache["v"], block_table,
                               q_positions=positions, impl=impl)
    return L.dense_apply(p["wo"], out.reshape(b, kk, cfg.q_dim).to(x.dtype))


RING_UNWRITTEN = 2**30  # the position of a ring slot never written: causally masked


def ragged_attn_verify_apply(p, cfg: ModelConfig, spec: LayerSpec, x, cache, rope,
                             positions, *, impl="cuda"):
    """``paged_attn_verify_apply`` for a sliding-window ring with per-row
    positions.  Writing the K tokens into the ring before attending would
    evict slots the early queries still need, so the ring is linearised:
    each slot is tagged with the position of the token it holds
    (``RING_UNWRITTEN`` if none), the K new tokens are appended as extra
    keys, and one banded attention over explicit positions scores all of
    them.  The ring is written later, by ``commit_ring``, with the accepted
    tokens only: a rejected token's write would evict a position that the
    next step still attends (the JAX package writes all K here, and its
    wrapped rings then hold rejected keys)."""
    if spec.window is None:
        raise ValueError("ragged verify is ring-cache only; use paged_attn_verify_apply")
    b, kk, _ = x.shape
    q, k, v = _project_qkv(p, cfg, x, rope)
    cap = cache["k"].shape[1]
    if kk > cap:
        raise ValueError(f"spec window {kk} exceeds ring capacity {cap}")
    p0 = positions[:, :1].long()  # (B, 1) position of the first new token
    s = torch.arange(cap, device=x.device)[None, :]
    # the latest position t < p0 with t % cap == s; t < 0: never written
    t = p0 - 1 - torch.remainder(p0 - 1 - s, cap)
    kv_pos = torch.where(t >= 0, t, RING_UNWRITTEN)
    keys = torch.cat([cache["k"].to(k.dtype), k], dim=1)
    vals = torch.cat([cache["v"].to(v.dtype), v], dim=1)
    kv_positions = torch.cat([kv_pos, positions.long()], dim=1).to(torch.int32)
    out = ops.mha(q, keys, vals, causal=True, window=spec.window, q_positions=positions,
                  kv_positions=kv_positions, impl=impl)
    cache["verify"] = (k, v, positions.long() % cap)
    return L.dense_apply(p["wo"], out.reshape(b, kk, cfg.q_dim).to(x.dtype))


def commit_ring(cache, keep):
    """Write the first ``keep[b]`` tokens of the last verify step into row
    b's ring (``keep``: (B,) on the device; a blend with the ring's own
    values, so no host sync)."""
    k, v, slot = cache.pop("verify")
    b, kk = slot.shape
    rows = torch.arange(b, device=slot.device)[:, None]
    take = (torch.arange(kk, device=slot.device)[None] < keep[:, None])[..., None, None]
    for name, new in (("k", k), ("v", v)):
        cache[name][rows, slot] = torch.where(take, new.to(cache[name].dtype),
                                              cache[name][rows, slot])
