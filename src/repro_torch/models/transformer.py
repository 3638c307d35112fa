"""The layer stack: one parameter dict per layer, run by a Python loop (the
JAX package stacks each group's layers and ``lax.scan``s them).

Four execution paths share the parameters:
  * ``stack_apply``        - full-sequence forward (padded, or a packed
                             cohort with ``cu_seqlens``: the train forward)
  * ``stack_prefill``      - full-sequence forward that also fills decode caches
  * ``stack_decode``       - single-token step through the caches
  * ``stack_paged_decode`` - single-token step with per-row positions through
                             paged caches (continuous batching)
  * ``stack_paged_verify`` - K-token speculative verify step with per-token
                             positions through paged caches (attention only)

``stack_apply_sharded``, ``stack_prefill_sharded`` and
``stack_decode_sharded`` run the first three over a mesh of logical
devices (tensor, data and expert parallelism, every mixer; see the end of
the file).

Every mixer is ported: attention, RG-LRU (``models/rglru.py``) and Mamba-2
SSD (``models/ssm.py``), with a gated-MLP FFN, an MoE FFN
(``models/moe.py``: the dropless or the capacity dispatch, with Arctic's
dense residual MLP) or none.  A recurrent layer's cache is its per-row
state.  ``stack_apply`` is also the train forward, padded for every mixer
and packed for attention-only stacks, dense or MoE; it carries the MoE
load-balance loss when asked.

An encoder-decoder model (``family == "encdec"``) runs a second stack of
the same layer pattern as its encoder (``stack_apply(causal=False)``), and
its decoder layers add cross-attention after the mixer's residual and
before the FFN (``lnx``, ``xattn``); a decoder layer's cache is then
{"self": the mixer's cache, "xkv": {"k", "v"}}, the cross-attention's k/v
of the encoder output computed once in prefill.  A prefix model's patch
embeddings are spliced in by ``model.py`` and need nothing here.  The
packed path refuses both (``check_packed``); the sharded path runs both.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.utils.checkpoint

from repro_torch.configs.base import ATTN, LRU, SSM, LayerSpec, ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from repro_torch.parallel.layout import tree_at, tree_leaves


def check_supported(cfg: ModelConfig):
    """Raise for the parts of ``cfg`` this port does not run yet."""
    kinds = {s.kind for s in cfg.layers}
    if not kinds <= {ATTN, LRU, SSM}:
        raise NotImplementedError(f"{cfg.name}: mixers {sorted(kinds - {ATTN, LRU, SSM})} "
                                  "are not ported")
    if cfg.ffn_kind not in ("gated", "moe", "none"):
        raise NotImplementedError(f"{cfg.name}: ffn_kind={cfg.ffn_kind!r} is not ported")


def block_init(gen, cfg: ModelConfig, spec: LayerSpec, device, cross: bool = False):
    dt = L.dtype_of(cfg)
    init = {ATTN: A.attn_init, LRU: R.lru_init, SSM: S.ssm_init}[spec.kind]
    p = {"ln1": L.rmsnorm_init(cfg.d_model, dt, device), "mixer": init(gen, cfg, device)}
    if cross:
        p["lnx"] = L.rmsnorm_init(cfg.d_model, dt, device)
        p["xattn"] = A.attn_init(gen, cfg, device, cross=True)
    if spec.has_ffn and cfg.ffn_kind != "none":
        p["ln2"] = L.rmsnorm_init(cfg.d_model, dt, device)
        p["ffn"] = (M.moe_init(gen, cfg, device) if cfg.ffn_kind == "moe"
                    else L.mlp_init(gen, cfg, device))
    return p


def _ffn(p, cfg, x, impl, want_aux=False):
    """The FFN sublayer.  Returns (x, aux): with ``want_aux`` an MoE
    layer's load-balance loss, else None."""
    if "ffn" not in p:
        return x, None
    h = L.rmsnorm_apply(p["ln2"], x, cfg.norm_eps)
    if cfg.ffn_kind != "moe":
        return x + L.mlp_apply(p["ffn"], cfg, h), None
    if want_aux:
        y, aux = M.moe_apply(p["ffn"], cfg, h, impl=impl, want_aux=True)
        return x + y, aux
    return x + M.moe_apply(p["ffn"], cfg, h, impl=impl), None


def _recurrent_decode(p, cfg, spec, h, cache):
    """A recurrent mixer's decode step: position-free, state in place."""
    if spec.kind == LRU:
        return R.lru_decode_apply(p["mixer"], cfg, h, cache)
    return S.ssm_decode_apply(p["mixer"], cfg, h, cache)


def check_packed(cfg: ModelConfig):
    """Raise for a config the packed (``cu_seqlens``) forward does not run:
    an encoder-decoder or prefix model (``AssertionError``, the JAX
    package's ``forward`` asserts this), or a recurrent mixer, which would
    scan across sequence boundaries (``NotImplementedError``, as the JAX
    package's ``block_apply``).  Dense and MoE FFNs are per-token and run
    packed."""
    if cfg.family == "encdec" or cfg.prefix_len:
        raise AssertionError(f"{cfg.name}: packed training supports decoder-only, "
                             "prefix-free configs")
    kinds = {s.kind for s in cfg.layers}
    if kinds != {ATTN}:
        raise NotImplementedError(f"{cfg.name}: packed training is attention-only; got "
                                  f"mixer kinds {sorted(kinds)}")


def _cross(p, cfg, x, enc_out, enc_kv, impl):
    """The decoder's cross-attention sublayer (nothing without an encoder)."""
    if enc_out is None and enc_kv is None:
        return x
    hx = L.rmsnorm_apply(p["lnx"], x, cfg.norm_eps)
    return x + A.cross_attn_apply(p["xattn"], cfg, hx, enc_out, enc_kv, impl=impl)


def block_apply(p, cfg, spec, x, rope, *, causal=True, impl="cuda", enc_out=None,
                enc_kv=None, cu_seqlens=None, max_seqlen=None, want_state=False,
                want_aux=False):
    """Full-sequence block.  Returns (x, aux, state): the MoE load-balance
    loss with ``want_aux`` (else None), and with ``want_state`` an
    attention layer's roped k/v or a recurrent layer's decode state after
    the last token, for prefill caching (else None).  ``causal=False`` is
    an encoder's self-attention; ``enc_out`` (or its cross k/v ``enc_kv``)
    adds a decoder layer's cross-attention.  Packed mode (``cu_seqlens``
    given; attention only, see ``check_packed``): x is a (1, T, D) packed
    cohort and attention goes block-diagonal over its segments."""
    h = L.rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    state = None
    if cu_seqlens is not None:
        y = A.attn_apply(p["mixer"], cfg, spec, h, rope, cu_seqlens, max_seqlen=max_seqlen,
                         impl=impl)
    elif spec.kind == ATTN:
        y, kv = A.attn_apply_with_kv(p["mixer"], cfg, spec, h, rope, causal=causal, impl=impl)
        state = kv if want_state else None
    else:
        mixer = R.lru_apply if spec.kind == LRU else S.ssm_apply
        y = mixer(p["mixer"], cfg, h, impl=impl, return_state=want_state)
        y, state = y if want_state else (y, None)
    x = _cross(p, cfg, x + y, enc_out, enc_kv, impl)
    x, aux = _ffn(p, cfg, x, impl, want_aux)
    return x, aux, state


def block_decode(p, cfg, spec, x, cache, t, rope, cache_len, *, impl="cuda", cross=False):
    """Single-token block step; updates ``cache`` in place (with ``cross``
    a decoder layer's {"self", "xkv"} cache)."""
    mixer_cache = cache["self"] if cross else cache
    h = L.rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    if spec.kind == ATTN:
        y = A.attn_decode_apply(p["mixer"], cfg, spec, h, mixer_cache, t, rope, cache_len,
                                impl=impl)
    else:
        y = _recurrent_decode(p, cfg, spec, h, mixer_cache)
    x = _cross(p, cfg, x + y, None, cache["xkv"] if cross else None, impl)
    return _ffn(p, cfg, x, impl)[0]


def block_paged_decode(p, cfg, spec, x, cache, block_table, dest, rope, cache_len,
                       *, impl="cuda"):
    """Single-token block step with per-row positions: full-attention
    layers go through the block pool, window layers through their per-slot
    rings; ``dest`` indexes each row's write into ``cache``; recurrent
    layers step their per-slot states.  Updates ``cache`` in place."""
    h = L.rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    if spec.kind != ATTN:
        y = _recurrent_decode(p, cfg, spec, h, cache)
    elif spec.window is None:
        y = A.paged_attn_decode_apply(p["mixer"], cfg, h, cache, block_table, dest,
                                      rope, cache_len, impl=impl)
    else:
        y = A.ragged_attn_decode_apply(p["mixer"], cfg, spec, h, cache, dest, rope,
                                       cache_len, impl=impl)
    return _ffn(p, cfg, x + y, impl)[0]


def block_paged_verify(p, cfg, spec, x, cache, block_table, dest, rope, positions, *,
                       impl="cuda"):
    """K-token speculative verify block step: x (B, K, D) at positions
    (B, K).  Attention only: a recurrent mixer would need its state rolled
    back on a rejected draft (the spec entry points refuse it up front).
    Updates ``cache`` in place."""
    if spec.kind != ATTN:
        raise ValueError(f"the verify step is attention-only; got mixer kind {spec.kind}")
    h = L.rmsnorm_apply(p["ln1"], x, cfg.norm_eps)
    if spec.window is None:
        y = A.paged_attn_verify_apply(p["mixer"], cfg, h, cache, block_table, dest, rope,
                                      positions, impl=impl)
    else:
        y = A.ragged_attn_verify_apply(p["mixer"], cfg, spec, h, cache, rope, positions,
                                       impl=impl)
    return _ffn(p, cfg, x + y, impl)[0]


def stack_init(gen, cfg: ModelConfig, device, cross: bool = False):
    """One parameter dict per layer; ``cross`` adds the decoder layers'
    cross-attention."""
    check_supported(cfg)
    return [block_init(gen, cfg, spec, device, cross) for spec in cfg.layers]


def _rope(cfg: ModelConfig, positions):
    """The RoPE tables of ``positions``, or None for a model without
    attention layers (mamba2 has head_dim 0)."""
    if not any(s.kind == ATTN for s in cfg.layers):
        return None
    return L.rope_tables(positions, cfg.head_dim, cfg.rope_theta)


def _arange_rope(cfg: ModelConfig, x):
    return _rope(cfg, torch.arange(x.shape[1], device=x.device))


def stack_apply(layers_params, cfg: ModelConfig, x, positions=None, *, causal=True,
                impl="cuda", enc_out=None, cu_seqlens=None, max_seqlen=None, remat=False,
                return_aux=False):
    """Full-sequence forward at ``positions`` ((1, S); None means arange).
    Returns x, or with ``return_aux`` (x, aux): the MoE layers' load-balance
    losses summed, a 0-d fp32 tensor (0 without MoE layers), as the JAX
    package's ``stack_apply`` carries it.  ``causal=False`` runs an
    encoder; ``enc_out`` (B, S_enc, D) feeds a decoder's cross-attention.

    Packed mode (``cu_seqlens`` given): x is a (1, T, D) packed cohort and
    ``positions`` its within-sequence positions.  ``remat`` recomputes each
    layer's activations in the backward (``torch.utils.checkpoint``, the
    counterpart of the JAX package's ``jax.checkpoint`` per layer group);
    the recompute runs each layer's forward, kernels included, a second
    time."""
    if cu_seqlens is not None:
        check_packed(cfg)
    rope = _arange_rope(cfg, x) if positions is None else _rope(cfg, positions)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, spec in zip(layers_params, cfg.layers):
        def layer(x, enc_out, p=p, spec=spec):
            return block_apply(p, cfg, spec, x, rope, causal=causal, impl=impl,
                               enc_out=enc_out, cu_seqlens=cu_seqlens, max_seqlen=max_seqlen,
                               want_aux=return_aux)[:2]
        x, aux = (torch.utils.checkpoint.checkpoint(layer, x, enc_out, use_reentrant=False)
                  if remat else layer(x, enc_out))
        if aux is not None:
            aux_total = aux_total + aux
    return (x, aux_total) if return_aux else x


def layer_cache_init(cfg: ModelConfig, spec: LayerSpec, batch, max_len, dtype, device):
    """One layer's decode cache: k/v buffers for attention, the per-row
    state for a recurrent mixer."""
    if spec.kind == ATTN:
        return A.cache_init(cfg, spec, batch, max_len, dtype, device)
    if spec.kind == LRU:
        return R.lru_state_init(cfg, batch, dtype, device)
    return S.ssm_state_init(cfg, batch, dtype, device)


def _with_xkv(cache, cfg: ModelConfig, batch, enc_len, dtype, device):
    """A decoder layer's {"self": ``cache``, "xkv": {"k", "v"}: (B, enc_len,
    Hkv, Dh)} (``cfg``'s KV heads)."""
    shape = (batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
    return {"self": cache, "xkv": {"k": torch.zeros(shape, dtype=dtype, device=device),
                                   "v": torch.zeros(shape, dtype=dtype, device=device)}}


def cache_init(cfg: ModelConfig, batch, max_len, dtype, device, cross=False, enc_len=None):
    """One decode cache per layer; with ``cross`` (an encoder-decoder's
    decoder) each is {"self": the mixer's cache, "xkv": {"k", "v"}: (B,
    enc_len, Hkv, Dh)}."""
    caches = [layer_cache_init(cfg, spec, batch, max_len, dtype, device) for spec in cfg.layers]
    if not cross:
        return caches
    return [_with_xkv(c, cfg, batch, enc_len, dtype, device) for c in caches]


def stack_prefill(layers_params, cfg: ModelConfig, x, caches, *, impl="cuda", enc_out=None):
    """Full forward that fills the decode caches (from ``cache_init``) in
    place.  With ``enc_out`` each decoder layer computes its cross k/v once,
    attends with it as computed and stores it in its "xkv" cache (cast to
    the cache's dtype, as the JAX package casts it to ``cfg.dtype``).
    Returns x."""
    rope = _arange_rope(cfg, x)
    seq_len = x.shape[1]
    for p, spec, cache in zip(layers_params, cfg.layers, caches):
        xkv = None
        if enc_out is not None:
            xkv = A.encode_cross_kv(p["xattn"], cfg, enc_out)
            for name, value in xkv.items():
                cache["xkv"][name].copy_(value)
            cache = cache["self"]
        x, _, state = block_apply(p, cfg, spec, x, rope, impl=impl, enc_kv=xkv,
                                  want_state=True)
        if spec.kind == ATTN:
            A.prefill_into_cache(cache, spec, state["k"], state["v"], seq_len)
        else:
            _store(cache, state)
    return x


def _store(cache, state):
    """A recurrent layer's prefill state copied into its decode cache."""
    for name, value in state.items():
        cache[name].copy_(value)


def stack_decode(layers_params, cfg: ModelConfig, x, caches, t, *, impl="cuda", cross=False):
    """x: (B, 1, D); t: the token's position.  Updates ``caches`` in place
    and returns x (``cross``: an encoder-decoder's decoder, its caches
    ``cache_init(cross=True)``'s).  The RoPE tables and cache lengths of the
    step are built once here, not per layer."""
    rope = _rope(cfg, torch.full((1, 1), t, device=x.device))
    cache_len = torch.full((x.shape[0],), t + 1, dtype=torch.int32, device=x.device)
    for p, spec, cache in zip(layers_params, cfg.layers, caches):
        x = block_decode(p, cfg, spec, x, cache, t, rope, cache_len, impl=impl, cross=cross)
    return x


def stack_paged_decode(layers_params, cfg: ModelConfig, x, caches, block_table,
                       positions, *, impl="cuda"):
    """x: (B, 1, D); block_table: (B, M) int32; positions: (B,) int32, each
    row's token position.  Updates ``caches`` in place and returns x.  The
    RoPE tables, cache lengths and write indices of the step are built once
    here, not per layer: a pool's (block, offset) pair is shared by every
    full-attention layer, a ring's (row, slot) pair by every window layer
    of its length.  Recurrent layers need none of them."""
    rope = _rope(cfg, positions[:, None])
    cache_len = positions + 1
    rows = torch.arange(x.shape[0], device=x.device)
    dests = {None: None}
    for p, spec, cache in zip(layers_params, cfg.layers, caches):
        # a pool's block size, or a ring's length
        key = (spec.window is None, cache["k"].shape[1]) if spec.kind == ATTN else None
        if key not in dests:
            paged, n = key
            dests[key] = ((block_table[rows, positions // n], positions % n) if paged
                          else (rows, positions % n))
        x = block_paged_decode(p, cfg, spec, x, cache, block_table, dests[key], rope,
                               cache_len, impl=impl)
    return x


def stack_paged_verify(layers_params, cfg: ModelConfig, x, caches, block_table, positions,
                       *, impl="cuda"):
    """x: (B, K, D), one speculative verify window per row; block_table:
    (B, M) int32; positions: (B, K) int32 per-token positions.  Updates
    ``caches`` in place and returns x.  The RoPE tables and the pools'
    (block, offset) write indices are built once here, not per layer."""
    rope = _rope(cfg, positions)
    dests = {}
    rows = torch.arange(x.shape[0], device=x.device)[:, None]
    for p, spec, cache in zip(layers_params, cfg.layers, caches):
        dest = None
        if spec.kind == ATTN and spec.window is None:
            bs = cache["k"].shape[1]
            if bs not in dests:
                pos = positions.long()
                dests[bs] = (block_table[rows, pos // bs].long(), pos % bs)
            dest = dests[bs]
        x = block_paged_verify(p, cfg, spec, x, cache, block_table, dest, rope, positions,
                               impl=impl)
    return x


def stack_commit_verify(cfg: ModelConfig, caches, keep):
    """After a verify step's acceptance: write the first ``keep[b]`` window
    tokens of row b into each window layer's ring (``attention.commit_ring``).
    The pools need nothing: a rejected position there is masked until the
    next step overwrites it."""
    for spec, cache in zip(cfg.layers, caches):
        if spec.kind == ATTN and spec.window is not None:
            A.commit_ring(cache, keep)


# ------------------------------------------------------------------ sharded
# Explicit SPMD over a mesh of logical devices (``parallel/steps.py``): a
# per-rank value is a dict {logical id: tensor}, every rank's local block
# runs the single-device code above with ``tp_cfg``'s local head, channel
# and FFN counts, and the collectives sit where GSPMD puts them in the JAX
# package: column-parallel wq/wk/wv/w_gate/w_in/in_proj, row-parallel
# wo/w_out/out_proj followed by an all-reduce over the tensor axis (each
# rank's share of the product in fp32, summed, cast once), MoE experts
# split over the same axis (``moe.moe_apply_sharded``).  Where the tensor
# axis does not divide the KV heads (recurrentgemma's one, gemma3's one),
# wk/wv keep their column blocks, which split a head, and each rank
# all-gathers them over the tensor axis inside the layer, computes every
# KV head and attends its query heads against their group's; such a
# layer's KV cache holds every KV head and splits its slots over the
# tensor axis instead (``seq_split``: ceil-sized blocks, as the JAX
# package's cache holds a 16th of its bytes per card), and in decode each
# rank attends every query head over its own slots (wq gathered too), the
# ranks' fp32 partials merge by log-sum-exp (``ctx.lse_merge``) and each
# rank's wo rows take its own q_dim / tp columns.  Where the axis
# splits a query head as well (qwen2-0.5b's 14 heads at 4 or 16), or
# gives a rank query heads of two KV groups, wq keeps its q_dim / tp
# column blocks, as GSPMD splits them: each rank all-gathers wq too,
# computes every head and takes its own q_dim / tp columns of the
# attention output into its wo rows (``heads_split``).  The RG-LRU block
# splits by channel (``rglru.py``), the SSD block by head
# (``ssm.ssm_apply_sharded``).  An encoder-decoder's encoder is the same
# stack run non-causal (``causal=False``); a decoder layer's cross-attention
# splits by head as self-attention does (its wq/wk/wv columns, its wo rows,
# the shares all-reduced), against every rank's copy of its batch rows'
# encoder output, and its "xkv" cache holds the rank's KV heads.  A packed
# cohort runs as each rank's (1, T_r) rows: attention goes through the
# varlen kernel over the rank's ``cu_seqlens`` with the same head split.
# Where the tensor axis does not divide a block's defining width (wq's and
# wo's q_dim for attention and cross-attention, d_ff for a dense FFN and
# for Arctic's dense residual, the expert axis, lru_width, out_proj's SSD
# rows or the SSD heads), ``sanitize_specs`` leaves the block's weights
# whole, and the JAX package's GSPMD then replicates the block: so does the
# port (``layer_plan``, read from the layout as the vocabulary's split is).
# Every tensor rank runs the whole block on its own copy under
# ``ctx.whole()`` (no tensor axis: every head, channel, expert and SSD
# head, one block of slots where the data axis splits a batch-1 cache) and
# keeps its own result, which is never summed over the tensor axis; a leaf
# of such a block that the layout still splits is all-gathered inside the
# layer.  The residual stream's gradient is a share per tensor rank below
# a split block and the head; a run of whole sublayers takes the whole on
# every rank (summed once where the run ends, kept on the root where it
# begins: ``block_sharded``), so each copy's weight gradient is whole and is
# not summed over the tensor axis (``full_grad_leaves``).  A whole block's
# caches hold every KV head, SSD head and RG-LRU channel on every tensor
# rank, as JAX's do.
# ``ctx`` is a ``parallel/ctx.ShardingCtx``.

def check_sharded(cfg: ModelConfig, tp: int):
    """Raise for a config the sharded stack does not run at tensor-parallel
    degree ``tp``: a mixer or FFN the port does not run
    (``check_supported``), or a ring shorter than the ``tp`` ranks that
    would split its slots (``seq_split`` of an attention layer the axis
    splits, ``ValueError``).  Every degree runs otherwise: where the axis
    does not divide q_dim, d_ff, the experts, lru_width or the SSD heads,
    the JAX package's ``sanitize_specs`` leaves that block's weights whole
    and GSPMD replicates the block over the axis; the port runs it whole on
    every tensor rank (``layer_plan``)."""
    check_supported(cfg)
    rings = [s.window for s in cfg.layers if s.kind == ATTN and s.window]
    if cfg.q_dim % tp == 0 and seq_split(cfg, tp) and rings and min(rings) < tp:
        raise ValueError(f"{cfg.name}: a ring of {min(rings)} slots is shorter than the {tp} "
                         "ranks that split it by slot")


def heads_split(cfg: ModelConfig, tp: int) -> bool:
    """Whether a tensor axis of ``tp`` splits a query head (it does not
    divide the query heads) or gives a rank query heads of more than one
    KV group without whole groups.  Then every rank computes every head
    (wq, wk, wv all-gathered) and its wo rows take its own q_dim / tp
    columns of the output."""
    if tp == 1 or not cfg.n_heads:
        return False
    if cfg.n_heads % tp:
        return True
    local, group = cfg.n_heads // tp, cfg.n_heads // cfg.n_kv_heads
    return cfg.n_kv_heads % tp != 0 and group % local != 0


def kv_replicated(cfg: ModelConfig, tp: int) -> bool:
    """Whether each rank computes every KV head (the tensor axis does not
    divide them; always so where ``heads_split``)."""
    return bool(cfg.n_kv_heads) and cfg.n_kv_heads % tp != 0


def seq_split(cfg: ModelConfig, tp: int) -> bool:
    """Whether an attention layer's decode cache splits its slots over a
    tensor axis of ``tp`` (exactly where ``kv_replicated``: every rank
    computes every KV head, and holds them for its own block of slots)."""
    return kv_replicated(cfg, tp)


def attn_slots(cfg: ModelConfig, spec: LayerSpec, ctx, rank: int, rows: int, max_len: int):
    """Rank ``rank``'s ``ctx.Slots`` block of an attention layer's decode
    cache (``rows`` rows, ``max_len`` positions), or None where every rank
    holds all of its slots: split over the tensor axis where ``seq_split``,
    and over the data axis by the JAX package's batch-1 rule
    (``ShardingCtx.seq_axes``)."""
    cap = A.cache_cap(spec, max_len)
    axes = ctx.seq_axes(seq_split(cfg, ctx.tp_size), rows, cap)
    return ctx.slots(axes, cap, rank) if axes else None


def tp_cfg(cfg: ModelConfig, tp: int) -> ModelConfig:
    """The config of one rank's local block at a tensor axis of ``tp`` that
    splits it (``layer_plan``; a whole block runs at ``tp`` 1, ``cfg``
    itself): its query heads (all of them where ``heads_split``), its KV
    heads (all of them where ``kv_replicated``), its RG-LRU channels and
    FFN width, a dense one's or the dense residual MLP's beside the
    experts.  The SSD width derives from ``d_model``, so the SSD layer
    takes its head count, H / tp, as an argument."""
    if tp == 1:
        return cfg
    kv = cfg.n_kv_heads if kv_replicated(cfg, tp) else cfg.n_kv_heads // tp
    heads = cfg.n_heads if heads_split(cfg, tp) else cfg.n_heads // tp
    return dataclasses.replace(cfg, n_heads=heads, n_kv_heads=kv,
                               d_ff=cfg.d_ff // tp, lru_width=cfg.lru_width // tp)


# The parts of a layer that each run under their own context, and the
# sublayers they make up with their norms: (norm, parts).
_PARTS = ("mixer", "xattn", "ffn", "dense")
_SUBLAYERS = (("ln1", ("mixer",)), ("lnx", ("xattn",)), ("ln2", ("ffn", "dense")))


def _defining(cfg: ModelConfig, kind, part: str):
    """(path in the layer, dim) of the weight whose layout says whether the
    tensor axis splits ``part``."""
    if part == "mixer" and kind == LRU:
        return ("mixer", "w_out", "w"), 0
    if part == "mixer" and kind == SSM:
        return ("mixer", "out_proj", "w"), 0
    if part in ("mixer", "xattn"):
        return (part, "wq", "w"), 1
    if part == "dense":
        return ("ffn", "dense", "w_out", "w"), 0
    if cfg.ffn_kind == "moe":
        return ("ffn", "w_gate"), 0
    return ("ffn", "w_out", "w"), 0


def layer_plan(cfg: ModelConfig, spec: LayerSpec, ctx, p) -> dict:
    """{part: the context it runs under} of one layer, read from ``p``, its
    tree of ``ShardedTensor``s: ``ctx`` where the tensor axis splits the
    part's defining weight, a ``ctx.whole()`` where the layout leaves it
    whole (``sanitize_specs``: the axis does not divide its width).  The
    parts are "mixer", "xattn" (a decoder layer's cross-attention), "ffn"
    (a dense FFN, or an MoE layer's experts and router) and "dense" (an MoE
    layer's dense residual MLP), those the layer has.  The SSD mixer splits
    by head, so it runs whole also where the axis splits its ``out_proj``
    rows but not its heads.  A whole part's copies get whole gradients
    (``whole(full_grads=True)``) unless it shares its sublayer with a split
    part (experts whole beside a split dense residual, or the reverse)."""
    parts = [k for k in ("mixer", "xattn", "ffn") if k in p]
    if "ffn" in p and "dense" in p["ffn"]:
        parts.append("dense")
    if ctx.tp_size == 1:
        return {part: ctx for part in parts}
    splits = {}
    for part in parts:
        path, dim = _defining(cfg, spec.kind, part)
        splits[part] = ctx.tp_splits(tree_at(p, path), dim)
    if spec.kind == SSM:
        splits["mixer"] = splits["mixer"] and cfg.ssm_heads % ctx.tp_size == 0
    mixed = "dense" in splits and splits["dense"] != splits["ffn"]
    return {part: ctx if split else ctx.whole(full_grads=not (mixed and part in ("ffn", "dense")))
            for part, split in splits.items()}


def layer_plans(layers_params, cfg: ModelConfig, ctx) -> list:
    """``layer_plan`` of every layer, ``layers_params`` their trees of
    ``ShardedTensor``s."""
    return [layer_plan(cfg, spec, ctx, p) for p, spec in zip(layers_params, cfg.layers)]


def _full(plan: dict, parts) -> bool:
    """Whether the sublayer of ``parts`` runs whole with whole gradients on
    every copy (its first part's context says so for all of them)."""
    part = next((k for k in parts if k in plan), None)
    return part is not None and plan[part].copies is not None


def full_grad_leaves(params, cfg: ModelConfig, ctx) -> list:
    """The ``ShardedTensor`` leaves of the model's ``params`` whose gradient
    every tensor rank holds whole after the backward: those of a sublayer
    (its norm and its parts) of the layers, an encoder's too, that runs
    whole with whole gradients (``block_sharded``), so
    ``steps.sharded_grads`` sums them over the batch axes only."""
    stacks = [params["layers"]] + ([params["encoder"]["layers"]] if "encoder" in params else [])
    out = []
    for layers in stacks:
        for p, plan in zip(layers, layer_plans(layers, cfg, ctx)):
            for norm, parts in _SUBLAYERS:
                if _full(plan, parts):
                    out += tree_leaves(p[norm]) + [x for k in parts if k in p
                                                   for x in tree_leaves(p[k])]
    return out


def _local_layer(p, plan: dict, ctx) -> dict:
    """{rank: the layer's compute view}: each part's leaves gathered by its
    own context's ``local`` (a whole part's over the tensor axis too), the
    norms by ``ctx``'s."""
    out = ctx.local({k: v for k, v in p.items() if k not in _PARTS})
    for part, c in plan.items():  # "dense" after "ffn"
        tree = p["ffn"]["dense"] if part == "dense" else p[part]
        if part == "ffn":
            tree = {k: v for k, v in tree.items() if k != "dense"}
        for r, local in c.local(tree).items():
            if part == "dense":
                out[r]["ffn"]["dense"] = local
            else:
                out[r][part] = local
    return out


def _kv_head(cfg: ModelConfig, ctx, r: int):
    """The KV head rank r's query heads attend where KV is replicated and
    each rank keeps its own query heads, else None (the rank holds its own
    KV heads, or computes every head)."""
    tp = ctx.tp_size
    if not kv_replicated(cfg, tp) or heads_split(cfg, tp):
        return None
    return ctx.tp_index(r) * (cfg.n_heads // tp) // (cfg.n_heads // cfg.n_kv_heads)


def _own_cols(cfg: ModelConfig, ctx, r: int) -> slice:
    """The columns of the attention output that rank r's wo rows take (its
    own q_dim / tp, as its wq block)."""
    w = cfg.q_dim // ctx.tp_size
    i = ctx.tp_index(r)
    return slice(i * w, (i + 1) * w)


def _out_cols(cfg: ModelConfig, ctx, r: int):
    """Where ``heads_split`` (every rank computes every head): rank r's
    ``_own_cols``, else None."""
    return _own_cols(cfg, ctx, r) if heads_split(cfg, ctx.tp_size) else None


def _attn_whole(pms: dict, cfg: ModelConfig, ctx, kv: bool = True,
                whole_q: bool = False) -> dict:
    """{rank: the attention params with wk/wv (with ``kv``; where KV is
    replicated) and wq (where ``heads_split``, or with ``whole_q``), and
    their biases, whole}:
    their column blocks all-gathered over the tensor axis (unless
    ``sanitize_specs`` left them whole); the gather's backward, the
    reduce-scatter, lands each gradient on its block.  The q/k norms are
    per head_dim and on every rank already."""
    tp = ctx.tp_size
    names = ((("wk", "wv") if kv and kv_replicated(cfg, tp) else ())
             + (("wq",) if whole_q or heads_split(cfg, tp) else ()))
    if not names:
        return pms
    out = {r: dict(p) for r, p in pms.items()}
    for name in names:
        size = cfg.q_dim if name == "wq" else cfg.kv_dim
        leaves = {}
        for key in pms[next(iter(pms))][name]:
            leaves[key] = ctx.tp_gather({r: p[name][key] for r, p in pms.items()}, -1, size)
        for r in out:
            out[r][name] = {key: leaves[key][r] for key in leaves}
    return out


def _ropes(cfg: ModelConfig, positions: dict) -> dict:
    """{rank: RoPE tables} of {rank: positions}, built once per positions
    tensor (ranks of one replica on one torch device share theirs)."""
    by_pos = {}
    for pos in positions.values():
        if id(pos) not in by_pos:
            by_pos[id(pos)] = _rope(cfg, pos)
    return {r: by_pos[id(pos)] for r, pos in positions.items()}


def _per_device(xs: dict, make) -> dict:
    """{rank: ``make(device)``}, one tensor per torch device of ``xs``."""
    by_dev = {}
    for x in xs.values():
        if x.device not in by_dev:
            by_dev[x.device] = make(x.device)
    return {r: by_dev[x.device] for r, x in xs.items()}


def _ffn_sharded(ps, cfg, xs, *, plan, impl, want_aux):
    """The FFN sublayer on every rank under ``plan``'s contexts (its "ffn"
    and an MoE layer's "dense"): a split dense FFN's fp32 shares summed
    over the tensor axis, a whole one's output kept by each rank."""
    if "ffn" not in plan:
        return xs, None
    c = plan["ffn"]
    hs = {r: L.rmsnorm_apply(ps[r]["ln2"], x, cfg.norm_eps) for r, x in xs.items()}
    if cfg.ffn_kind != "moe":
        lcfg = tp_cfg(cfg, c.tp_size)
        ys = c.tp_reduce({r: L.mlp_apply(ps[r]["ffn"], lcfg, h, partial=True)
                          for r, h in hs.items()})
        return {r: xs[r] + ys[r].to(xs[r].dtype) for r in xs}, None
    ys, aux = M.moe_apply_sharded({r: p["ffn"] for r, p in ps.items()}, cfg, hs, ctx=c,
                                  dense_ctx=plan.get("dense"), impl=impl, want_aux=want_aux)
    return {r: xs[r] + ys[r] for r in xs}, aux


def _mixer_sharded(pms, cfg, spec, hs, *, ctx, impl, rope=None, caches=None, t=None,
                   lens=None, prefill=False, causal=True, max_len=None, cu_seqlens=None,
                   max_seqlen=None):
    """{rank: fp32 share of the mixer output} of {rank: normed input}: the
    layer's mixer on every rank, ``pms`` {rank: local mixer params}.  Full
    sequence (``rope`` {rank: tables}; ``causal=False`` an encoder's
    attention; with ``prefill`` it also fills ``caches`` {rank: the layer's
    mixer cache}; with ``cu_seqlens`` and ``max_seqlen`` {rank: its
    replica's} each rank's (1, T_r) packed cohort, attention only), or
    with ``t`` one decode token at position t against ``caches`` (``lens``
    {rank: cache lengths}).  ``max_len``: the caches' positions, which
    place an attention cache's slot blocks (``attn_slots``)."""
    tp = ctx.tp_size
    lcfg = tp_cfg(cfg, tp)
    decode = t is not None
    if cu_seqlens is not None:
        pms = _attn_whole(pms, cfg, ctx)
        return {r: A.attn_apply(pms[r], lcfg, spec, h, rope[r], cu_seqlens[r],
                                max_seqlen=max_seqlen[r], impl=impl, partial=True,
                                kv_head=_kv_head(cfg, ctx, r), cols=_out_cols(cfg, ctx, r))
                for r, h in hs.items()}
    if spec.kind == SSM:
        heads = cfg.ssm_heads // tp
        if decode:
            return S.ssm_decode_sharded(pms, cfg, hs, caches, ctx=ctx, heads=heads)
        out = S.ssm_apply_sharded(pms, cfg, hs, ctx=ctx, heads=heads, impl=impl,
                                  return_state=prefill)
        if not prefill:
            return out
        out, states = out
        for r, st in states.items():
            _store(caches[r], st)
        return out
    ys = {}
    if spec.kind == LRU:
        for r, h in hs.items():
            if decode:
                ys[r] = R.lru_decode_apply(pms[r], lcfg, h, caches[r], partial=True)
                continue
            y = R.lru_apply(pms[r], lcfg, h, impl=impl, return_state=prefill, partial=True)
            if prefill:
                y, st = y
                _store(caches[r], st)
            ys[r] = y
        return ys
    slots = ({r: attn_slots(cfg, spec, ctx, r, h.shape[0], max_len) for r, h in hs.items()}
             if decode or prefill else {})
    if decode and slots[next(iter(hs))] is not None:
        return _attn_decode_split(pms, cfg, spec, hs, caches, t, rope, slots, ctx=ctx, impl=impl)
    if decode:  # the rank's own KV heads, whole on its cache
        return {r: A.attn_decode_apply(pms[r], lcfg, spec, h, caches[r], t, rope[r], lens[r],
                                       impl=impl, partial=True)
                for r, h in hs.items()}
    pms = _attn_whole(pms, cfg, ctx)
    for r, h in hs.items():
        ys[r], kv = A.attn_apply_with_kv(pms[r], lcfg, spec, h, rope[r], causal=causal,
                                         impl=impl, partial=True,
                                         kv_head=_kv_head(cfg, ctx, r),
                                         cols=_out_cols(cfg, ctx, r))
        if prefill:
            A.prefill_into_cache(caches[r], spec, kv["k"], kv["v"], h.shape[1],
                                 slots=slots[r])
    return ys


def _attn_decode_split(pms, cfg, spec, hs, caches, t, rope, slots, *, ctx, impl):
    """An attention layer's decode over a cache split by slot (``slots``
    {rank: its ``ctx.Slots``}): each rank's query heads (every one where the
    slots split over the tensor axis) attend its block, the partials merge
    over the block's axes in fp32 and are cast once, and each rank's wo
    rows take their columns.  Returns {rank: fp32 share of the output}."""
    axes = slots[next(iter(hs))].axes
    whole_q = ctx.tp_axis in axes
    lcfg = tp_cfg(cfg, ctx.tp_size)
    if whole_q:
        lcfg = dataclasses.replace(lcfg, n_heads=cfg.n_heads)
    pms = _attn_whole(pms, cfg, ctx, whole_q=whole_q)
    outs, lses = {}, {}
    for r, h in hs.items():
        outs[r], lses[r] = A.attn_decode_partial(pms[r], lcfg, spec, h, caches[r], t, rope[r],
                                                 slots[r], impl=impl)
    merged = ctx.lse_merge(outs, lses, axes)
    return {r: A.decode_out(pms[r], lcfg, merged[r], h.dtype,
                            cols=_own_cols(cfg, ctx, r) if whole_q else None)
            for r, h in hs.items()}


def _cross_sharded(ps, cfg, xs, *, ctx, impl, enc_outs=None, caches=None):
    """The decoder's cross-attention sublayer on every rank (``_cross``):
    each rank's query heads against its KV heads (every one where the
    tensor axis does not divide them, wk/wv gathered as ``_attn_whole``;
    every query head where it splits one, wq gathered too), its fp32 share
    of the wo product all-reduced and cast once.  The k/v come from
    ``enc_outs`` {rank: the encoder output of its rows} (with ``caches``
    {rank: the layer's cache}, a prefill, which stores them in "xkv" in the
    cache's dtype), or from the "xkv" caches (decode)."""
    lcfg = tp_cfg(cfg, ctx.tp_size)
    pxs = _attn_whole({r: p["xattn"] for r, p in ps.items()}, cfg, ctx,
                      kv=enc_outs is not None)
    if enc_outs is None:
        kvs = {r: c["xkv"] for r, c in caches.items()}
    else:
        kvs = {r: A.encode_cross_kv(pxs[r], lcfg, e) for r, e in enc_outs.items()}
        for r, c in (caches or {}).items():
            _store(c["xkv"], kvs[r])
    ys = ctx.tp_reduce({r: A.cross_attn_apply(pxs[r], lcfg,
                                              L.rmsnorm_apply(ps[r]["lnx"], x, cfg.norm_eps),
                                              enc_kv=kvs[r], impl=impl, partial=True,
                                              kv_head=_kv_head(cfg, ctx, r),
                                              cols=_out_cols(cfg, ctx, r))
                        for r, x in xs.items()})
    return {r: xs[r] + ys[r].to(xs[r].dtype) for r in xs}


def _stream(xs, full: bool, was: bool, ctx) -> dict:
    """The residual stream entering a sublayer that runs whole with whole
    gradients (``full``) or not, from one that did (``was``).  Below such a
    sublayer the stream's gradient is a share per tensor rank, the shares
    summing to the whole (the split blocks' all-reduces and the
    vocabulary-parallel head leave it so); within it the whole, on every
    rank.  Going in keeps the gradient on the tensor axis's root
    (``tp_grad_root``: the whole, counted once); coming out sums the shares
    (``tp_grad_sum``: one all-reduce of the activation gradient)."""
    if full == was:
        return xs
    return ctx.tp_grad_root(xs) if full else ctx.tp_grad_sum(xs)


def _last_full(plan: dict) -> bool:
    """Whether the layer's last sublayer runs whole with whole gradients."""
    return next(_full(plan, parts) for _, parts in reversed(_SUBLAYERS)
                if any(k in plan for k in parts))


def block_sharded(p, plan, cfg, spec, xs, *, ctx, impl="cuda", want_aux=False, enc_outs=None,
                  caches=None, full_in=False, **mixer_kw):
    """One block on every rank.  p: the layer's tree of ``ShardedTensor``s,
    each part gathered inside the layer under its context in ``plan``
    (``layer_plan``); xs: {rank: (B_r, S, D)}; caches: {rank: the layer's
    cache} (a decoder layer's {"self", "xkv"}); ``enc_outs`` and
    ``mixer_kw`` as ``_cross_sharded``'s and ``_mixer_sharded``'s.  A split
    mixer's fp32 shares are all-reduced over the tensor axis and cast once,
    a whole one's output cast on its own rank; a decoder layer's
    cross-attention follows.  ``full_in``: the stream comes from a sublayer
    that ran whole with whole gradients; each sublayer routes the
    gradient in and out of such runs (``_stream``), and the stream leaves
    in its last sublayer's mode (``_last_full``).  Returns (xs, aux):
    {rank: MoE load-balance loss} with ``want_aux``, else None."""
    ps = _local_layer(p, plan, ctx)
    cross = "xattn" in plan
    mixer_caches = {r: c["self"] for r, c in caches.items()} if cross and caches else caches
    full = _full(plan, ("mixer",))
    xs = _stream(xs, full, full_in, ctx)
    hs = {r: L.rmsnorm_apply(ps[r]["ln1"], x, cfg.norm_eps) for r, x in xs.items()}
    mc = plan["mixer"]
    ys = mc.tp_reduce(_mixer_sharded({r: q["mixer"] for r, q in ps.items()}, cfg, spec, hs,
                                     ctx=mc, impl=impl, caches=mixer_caches, **mixer_kw))
    xs = {r: xs[r] + ys[r].to(xs[r].dtype) for r in xs}
    if cross:
        was, full = full, _full(plan, ("xattn",))
        xs = _stream(xs, full, was, ctx)
        if full and enc_outs is not None:  # the encoder's gradient, a share per rank
            enc_outs = ctx.tp_grad_root(enc_outs)
        xs = _cross_sharded(ps, cfg, xs, ctx=plan["xattn"], impl=impl, enc_outs=enc_outs,
                            caches=caches)
    if "ffn" in plan:
        was, full = full, _full(plan, ("ffn",))
        xs = _stream(xs, full, was, ctx)
    xs, aux = _ffn_sharded(ps, cfg, xs, plan=plan, impl=impl, want_aux=want_aux)
    if aux is not None and full:  # the loss takes the root's: every copy's router gets it
        aux = ctx.tp_grad_sum(aux)
    return xs, aux


def stack_apply_sharded(layers_params, cfg: ModelConfig, xs, *, ctx, impl="cuda", causal=True,
                        enc_outs=None, remat=False, return_aux=False, positions=None,
                        cu_seqlens=None, max_seqlen=None):
    """``stack_apply`` over a mesh: ``layers_params`` holds ``ShardedTensor``
    leaves, xs is {rank: (B_r, S, D)} at positions arange(S); ``causal=False``
    runs an encoder, ``enc_outs`` {rank: (B_r, S_enc, D)} feeds a decoder's
    cross-attention.  Packed (``cu_seqlens``, ``positions`` and
    ``max_seqlen`` {rank: its replica's}; attention-only stacks,
    ``check_packed``): xs is {rank: its (1, T_r, D) cohort}, RoPE restarts
    per sequence at its ``positions`` and attention is block-diagonal
    over its ``cu_seqlens``.  Each layer gathers its FSDP-sharded weights
    (``ctx.local``) inside the layer, so ``remat`` regathers them in the
    backward as it recomputes, with the same ``cu_seqlens``.  The stream
    enters and leaves with its gradient a share per tensor rank
    (``block_sharded``).  Returns xs, or with ``return_aux`` (xs, {rank:
    the MoE losses summed})."""
    ranks = list(xs)
    n = len(ranks)
    packed = {}
    if cu_seqlens is not None:
        check_packed(cfg)
        packed = dict(cu_seqlens=cu_seqlens, max_seqlen=max_seqlen)
    else:
        s = next(iter(xs.values())).shape[1]
        positions = _per_device(xs, lambda dev: torch.arange(s, device=dev))
    ropes = _ropes(cfg, positions)
    aux_total = {r: torch.zeros((), dtype=torch.float32, device=x.device) for r, x in xs.items()}
    encs = [enc_outs[r] for r in ranks] if enc_outs is not None else []
    full = False
    for p, plan, spec in zip(layers_params, layer_plans(layers_params, cfg, ctx), cfg.layers):
        def layer(*flat, p=p, plan=plan, spec=spec, full=full):
            out, aux = block_sharded(p, plan, cfg, spec, dict(zip(ranks, flat[:n])),
                                     ctx=ctx, impl=impl, want_aux=return_aux, rope=ropes,
                                     causal=causal,
                                     enc_outs=dict(zip(ranks, flat[n:])) if encs else None,
                                     full_in=full, **packed)
            return tuple(out[r] for r in ranks) + (tuple(aux[r] for r in ranks) if aux else ())
        flat = [xs[r] for r in ranks] + encs
        res = (torch.utils.checkpoint.checkpoint(layer, *flat, use_reentrant=False) if remat
               else layer(*flat))
        xs = dict(zip(ranks, res[:len(ranks)]))
        for r, a in zip(ranks, res[len(ranks):]):
            aux_total[r] = aux_total[r] + a
        full = _last_full(plan)
    xs = _stream(xs, False, full, ctx)
    return (xs, aux_total) if return_aux else xs


def cache_init_sharded(cfg: ModelConfig, ctx, rank: int, batch, max_len, dtype, device, *,
                       plans, cross=False, enc_len=None):
    """Rank ``rank``'s decode caches on ``ctx``'s mesh: its own KV heads,
    or every one where ``kv_replicated`` (so where ``heads_split``) for its
    own block of the slots (``attn_slots``), its RG-LRU channels or SSD
    heads (``ssm.ssm_state_init_sharded``); a layer whose mixer runs whole
    (``plans``, the parameters' ``layer_plans``) holds every KV head for
    every slot (a batch-1 cache's data-axis block), every channel or every
    head.  With ``cross`` each is a decoder layer's {"self", "xkv"}, "xkv"
    over its cross-attention's KV heads and all of the encoder's positions
    (``cache_init``'s)."""
    caches = []
    for spec, plan in zip(cfg.layers, plans):
        c = plan["mixer"]
        tp = c.tp_size
        lcfg = tp_cfg(cfg, tp)
        if spec.kind == SSM:
            cache = S.ssm_state_init_sharded(cfg, batch, cfg.ssm_heads // tp, dtype, device)
        elif spec.kind == ATTN:
            cache = A.cache_init(lcfg, spec, batch, max_len, dtype, device,
                                 slots=attn_slots(cfg, spec, c, rank, batch, max_len))
        else:
            cache = layer_cache_init(lcfg, spec, batch, max_len, dtype, device)
        if cross:
            cache = _with_xkv(cache, tp_cfg(cfg, plan["xattn"].tp_size), batch, enc_len, dtype,
                              device)
        caches.append(cache)
    return caches


def stack_prefill_sharded(layers_params, cfg: ModelConfig, xs, caches, max_len, *, ctx,
                          impl="cuda", enc_outs=None):
    """``stack_prefill`` over a mesh: caches is {rank: the rank's layer
    caches} from ``cache_init_sharded`` at ``max_len``, filled in place
    (a cache split by slot with the tokens of its block); ``enc_outs``
    {rank: encoder output} as ``stack_apply_sharded``'s.  Returns xs."""
    s = next(iter(xs.values())).shape[1]
    ropes = _ropes(cfg, _per_device(xs, lambda dev: torch.arange(s, device=dev)))
    plans = layer_plans(layers_params, cfg, ctx)
    for i, (p, plan, spec) in enumerate(zip(layers_params, plans, cfg.layers)):
        xs, _ = block_sharded(p, plan, cfg, spec, xs, ctx=ctx, impl=impl, rope=ropes,
                              caches={r: c[i] for r, c in caches.items()}, prefill=True,
                              enc_outs=enc_outs, max_len=max_len)
    return xs


def stack_decode_sharded(layers_params, cfg: ModelConfig, xs, caches, t, max_len, *, ctx,
                         impl="cuda"):
    """``stack_decode`` over a mesh: xs {rank: (B_r, 1, D)}, the token at
    position t; caches as ``stack_prefill_sharded``'s at ``max_len``,
    updated in place (a decoder layer's cross-attention reads its "xkv").
    A cache whose slots every rank holds is read to t + 1; one split by slot
    to each rank's own valid slots (``ctx.Slots.length``).  Returns xs."""
    ropes = _ropes(cfg, _per_device(xs, lambda dev: torch.full((1, 1), t, device=dev)))
    lens = {r: torch.full((x.shape[0],), t + 1, dtype=torch.int32, device=x.device)
            for r, x in xs.items()}
    plans = layer_plans(layers_params, cfg, ctx)
    for i, (p, plan, spec) in enumerate(zip(layers_params, plans, cfg.layers)):
        xs, _ = block_sharded(p, plan, cfg, spec, xs, ctx=ctx, impl=impl, rope=ropes,
                              caches={r: c[i] for r, c in caches.items()}, t=t, lens=lens,
                              max_len=max_len)
    return xs
