"""Plain PyTorch versions of the kernels: attention and the grouped expert
FFN.

They compute what the JAX package's ``kernels/ref.py`` computes, on the same
layouts: the CPU tests hold them against it, and ``chip_smoke.py`` holds the
CUDA kernels against them on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -2.0**30  # large-but-finite; a row with no valid key averages all keys


def mha_ref(q, k, v, *, causal: bool = True, window: int | None = None,
            q_positions=None, kv_positions=None, q_chunk: int | None = 0):
    """Multi-head attention with grouped KV heads.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hq % Hkv == 0.
    ``window``: keys with q_pos - k_pos >= window are masked.  Positions
    default to arange; pass them ((B or 1, S) int) for decode or ring caches.
    Scores and softmax run in fp32.
    ``q_chunk``: loop over query chunks so the score working set is
    (B, H, q_chunk, Skv); exact.  0 = auto, None = never chunk.
    Returns (B, Sq, Hq, D) in v's dtype.
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    g = hq // hkv
    if q_positions is None:
        q_positions = torch.arange(sq, device=q.device)[None, :]
    if kv_positions is None:
        kv_positions = torch.arange(skv, device=q.device)[None, :]

    if q_chunk == 0:
        q_chunk = 256
    if q_chunk and sq > q_chunk and sq % q_chunk == 0 and sq == skv:
        outs = []
        for i in range(sq // q_chunk):
            lo, hi = i * q_chunk, (i + 1) * q_chunk
            klo = 0
            if causal and kv_positions.shape[0] == 1:
                # keys after this chunk's last query are masked; with a
                # window, so are keys before (first query - window + 1)
                khi = hi
                if window is not None:
                    klo = max(0, lo - window + 1)
            else:
                khi = skv
            outs.append(mha_ref(
                q[:, lo:hi], k[:, klo:khi], v[:, klo:khi], causal=causal,
                window=window, q_positions=q_positions[:, lo:hi],
                kv_positions=kv_positions[:, klo:khi], q_chunk=None))
        return torch.cat(outs, dim=1)

    qr = q.reshape(b, sq, hkv, g, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qr, k).to(torch.float32)
    logits = logits / math.sqrt(d)

    dq = q_positions[:, None, None, :, None]  # (b,1,1,sq,1)
    dk = kv_positions[:, None, None, None, :]  # (b,1,1,1,skv)
    mask = torch.ones((1, 1, 1, sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (dk <= dq)
    if window is not None:
        mask = mask & ((dq - dk) < window)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(b, sq, hq, d)


def decode_mha_ref(q, k_cache, v_cache, *, cache_len, window: int | None = None):
    """Single-token decode attention over a (ring or linear) KV cache.

    q: (B, Hq, D); k_cache/v_cache: (B, C, Hkv, D); ``cache_len``: (B,)
    tokens written so far (the new token's position + 1).  For a ring cache
    (C == window) every slot is valid once cache_len >= C.  A row with
    cache_len 0 has no valid key and averages all C slots.  Returns
    (B, Hq, D).
    """
    b, c, hkv, d = k_cache.shape
    hq = q.shape[1]
    g = hq // hkv
    qr = q.reshape(b, hkv, g, d)
    logits = torch.einsum("bhgd,bkhd->bhgk", qr, k_cache).to(torch.float32)
    logits = logits / math.sqrt(d)
    slots = torch.arange(c, device=q.device)[None, :]  # (1, C)
    n = cache_len.to(q.device)[:, None]  # (B, 1)
    cap = c if window is None else min(c, window)
    valid = slots < torch.clamp(n, max=cap)
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", probs.to(v_cache.dtype), v_cache)
    return out.reshape(b, hq, d)


def paged_decode_mha_ref(q, k_pool, v_pool, block_table, *, cache_len):
    """Single-token decode attention over a paged (block-pool) KV cache.

    q: (B, Hq, D); k_pool/v_pool: (N, bs, Hkv, D), a pool of N blocks of bs
    tokens; ``block_table``: (B, M) int physical block ids: logical
    position p of row b lives at ``pool[block_table[b, p // bs], p % bs]``;
    ``cache_len``: (B,) tokens written so far.  Table entries past the live
    prefix may point anywhere (conventionally block 0): every position >=
    cache_len is masked.  A row with cache_len 0 averages all M * bs slots.
    Returns (B, Hq, D).
    """
    b, m = block_table.shape
    _, bs, hkv, d = k_pool.shape
    idx = block_table.long()
    k_cache = k_pool[idx].reshape(b, m * bs, hkv, d)
    v_cache = v_pool[idx].reshape(b, m * bs, hkv, d)
    return decode_mha_ref(q, k_cache, v_cache, cache_len=cache_len)


def _gelu_tanh(x):
    return F.gelu(x, approximate="tanh")


# "gelu" is the tanh approximation, as jax.nn.gelu's default
ACTS = {"silu": F.silu, "gelu": _gelu_tanh}


# ---------------------------------------------------------------------------
# Grouped (dropless MoE) expert FFN
# ---------------------------------------------------------------------------

def expert_ids_of(group_sizes, n: int):
    """Per-row expert id of the expert-sorted layout: row i belongs to the
    first expert whose inclusive cumsum offset exceeds i.  Rows past the
    total are clamped to the last expert (``grouped_ffn_ref`` zeroes
    them).  Returns (n,) int32."""
    ends = torch.cumsum(group_sizes.to(torch.int32), 0, dtype=torch.int32)
    rows = torch.arange(n, dtype=torch.int32, device=group_sizes.device)
    eid = torch.searchsorted(ends, rows, right=True, out_int32=True)
    return eid.clamp(max=group_sizes.shape[0] - 1)


def grouped_ffn_ref(xs, group_sizes, w_gate, w_in, w_out, *, act="silu"):
    """Grouped gated expert FFN over expert-sorted rows (dropless MoE).

    xs: (N, D) rows sorted by expert; group_sizes: (E,) int32 rows per
    expert (should sum to N; rows past the total come out as zeros);
    w_gate/w_in: (E, D, F); w_out: (E, F, D).  Row i runs through expert
    ``expert_ids_of(group_sizes, N)[i]`` only.  A loop over experts, each
    taking ``act(x @ Wg[e]) * (x @ Wi[e]) @ Wo[e]`` on its contiguous rows
    in fp32 (the JAX package's per-row gather would hold N x D x F values).
    Reads the group offsets back to the host.  Returns (N, D) float32."""
    n, d = xs.shape
    f32 = torch.float32
    out = torch.zeros((n, d), dtype=f32, device=xs.device)
    lo = 0
    for e, end in enumerate(torch.cumsum(group_sizes, 0).tolist()):
        hi = min(int(end), n)
        if hi > lo:
            x = xs[lo:hi].to(f32)
            h = ACTS[act](x @ w_gate[e].to(f32)) * (x @ w_in[e].to(f32))
            out[lo:hi] = h @ w_out[e].to(f32)
        lo = max(lo, hi)
    return out
