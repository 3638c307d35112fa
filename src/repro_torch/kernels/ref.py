"""Plain PyTorch versions of the kernels: attention, the grouped expert
FFN (and its backward), the Mamba-2 SSD scan and the RG-LRU recurrence
(and its backward).

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


def _varlen_block(q, k, v, seg_q, seg_k, pos_q, pos_k, *, causal, window, g: int):
    """One (Tq, Tk) tile of packed varlen attention.  q: (Tq, Hq, D); k/v:
    (Tk, Hkv, D); seg_*/pos_*: segment ids and global positions.  Tokens
    attend only within their own segment (block-diagonal mask).  Scores and
    softmax run in fp32 (in float64 for float64 inputs, so that
    ``gradcheck`` can hold the gradient)."""
    tq, hq, d = q.shape
    hkv = k.shape[1]
    qr = q.reshape(tq, hkv, g, d)
    logits = torch.einsum("qhgd,khd->hgqk", qr, k).to(
        torch.promote_types(q.dtype, torch.float32))
    logits = logits / math.sqrt(d)
    mask = seg_q[:, None] == seg_k[None, :]
    if causal:
        mask = mask & (pos_k[None, :] <= pos_q[:, None])
    if window is not None:
        mask = mask & ((pos_q[:, None] - pos_k[None, :]) < window)
    logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("hgqk,khd->qhgd", probs.to(v.dtype), v)
    return out.reshape(tq, hq, d)


def mha_varlen_ref(q, k, v, cu_seqlens, *, causal: bool = True,
                   window: int | None = None, max_seqlen: int | None = None,
                   q_chunk: int = 128):
    """Packed variable-length attention, the plain version of
    ``varlen_attention.flash_mha_varlen``.

    q: (T, Hq, D); k/v: (T, Hkv, D): the B sequences concatenated on the
    token axis with offsets ``cu_seqlens`` ((B+1,) int).  A token attends
    only keys of its own sequence (causal within when ``causal``); tokens
    at or beyond ``cu_seqlens[-1]`` (phantoms) form one segment of their
    own, segment B.

    ``max_seqlen`` bounds the longest sequence: with it and ``causal`` the
    computation runs banded, query chunks of ``q_chunk`` against the
    trailing ``max_seqlen``-wide key band, so cost is O(T * max_seqlen)
    instead of O(T^2).  Cross-segment scores are set to the finite NEG_INF
    before the softmax and weigh exactly 0, so changing another sequence
    leaves a sequence's output bit-identical.
    """
    t, hq, d = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={hkv}")
    g = hq // hkv
    cu = cu_seqlens.to(device=q.device, dtype=torch.int64)
    pos = torch.arange(t, device=q.device)
    seg = torch.searchsorted(cu[1:], pos, right=True)

    band = max_seqlen if (causal and max_seqlen is not None) else None
    if band is None or t <= q_chunk:
        return _varlen_block(q, k, v, seg, seg, pos, pos, causal=causal,
                             window=window, g=g)
    outs = []
    for i in range(-(-t // q_chunk)):
        lo, hi = i * q_chunk, min((i + 1) * q_chunk, t)
        # the same-segment causal keys of queries [lo, hi) all lie in
        # [lo - band + 1, hi): a key more than band - 1 behind its query is
        # in an earlier sequence (sequences are contiguous, len <= band)
        klo = max(0, lo - band + 1)
        outs.append(_varlen_block(
            q[lo:hi], k[klo:hi], v[klo:hi], seg[lo:hi], seg[klo:hi],
            pos[lo:hi], pos[klo:hi], causal=causal, window=window, g=g))
    return torch.cat(outs, dim=0)


def decode_mha_ref(q, k_cache, v_cache, *, cache_len, window: int | None = None,
                   return_lse: bool = False):
    """Single-token decode attention over a (ring or linear) KV cache.

    q: (B, Hq, D); k_cache/v_cache: (B, C, Hkv, D); ``cache_len``: (B,)
    tokens written so far (the new token's position + 1).  For a ring cache
    (C == window) every slot is valid once cache_len >= C.  A row with
    cache_len 0 has no valid key and averages all C slots.  Returns
    (B, Hq, D).

    With ``return_lse``: (out, lse), out (B, Hq, D) fp32 (P V in fp32, so
    that a merge of such partials rounds once) and lse (B, Hq) fp32, the
    natural-log log-sum-exp of the scaled logits over the valid keys.  A row
    with no valid key (a rank whose block of a split cache is still empty)
    gives out 0 and lse -inf: weight exactly 0 in ``lse_merge``.
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
    if return_lse:
        logits = torch.where(valid[:, None, None, :], logits, -math.inf)
        lse = torch.logsumexp(logits, dim=-1)  # -inf where no key is valid
        probs = torch.exp(logits - torch.where(torch.isinf(lse), 0.0, lse)[..., None])
        out = torch.einsum("bhgk,bkhd->bhgd", probs, v_cache.to(torch.float32))
        return out.reshape(b, hq, d), lse.reshape(b, hq)
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
    return decode_mha_ref(q, gather_pool(k_pool, block_table), gather_pool(v_pool, block_table),
                          cache_len=cache_len)


def gather_pool(pool, block_table):
    """The (B, M * bs, Hkv, D) linear cache of each row's table blocks."""
    b, m = block_table.shape
    _, bs, hkv, d = pool.shape
    return pool[block_table.long()].reshape(b, m * bs, hkv, d)


def paged_verify_mha_ref(q, k_pool, v_pool, block_table, *, q_positions):
    """Multi-query (speculative verify) attention over a paged KV cache.

    q: (B, K, Hq, D), the K = spec_k + 1 verify tokens of each row, whose
    KV is already in the pool; ``q_positions``: (B, K) their absolute
    positions.  Query j attends every logical position <= q_positions[b, j]
    of the table-gathered cache (slot i of the gathered row is position
    i).  Returns (B, K, Hq, D)."""
    kv_positions = torch.arange(block_table.shape[1] * k_pool.shape[1],
                                device=q.device)[None]
    return mha_ref(q, gather_pool(k_pool, block_table), gather_pool(v_pool, block_table),
                   causal=True, window=None, q_positions=q_positions,
                   kv_positions=kv_positions, q_chunk=None)


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


def group_ends(group_sizes, n: int) -> list:
    """The experts' row offsets (cumulative sums of ``group_sizes``) read to
    the host.  On ``meta`` (the dry run) the sizes are data it does not
    have: the N rows split evenly over the experts, so the loop counts N
    rows of dropless work and reads every expert's weights once."""
    e = group_sizes.shape[0]
    if group_sizes.is_meta:
        return [n * (i + 1) // e for i in range(e)]
    return torch.cumsum(group_sizes, 0).tolist()


def grouped_ffn_ref(xs, group_sizes, w_gate, w_in, w_out, *, act="silu"):
    """Grouped gated expert FFN over expert-sorted rows (dropless MoE).

    xs: (N, D) rows sorted by expert; group_sizes: (E,) int32 rows per
    expert (should sum to N; rows past the total come out as zeros);
    w_gate/w_in: (E, D, F); w_out: (E, F, D).  Row i runs through expert
    ``expert_ids_of(group_sizes, N)[i]`` only.  A loop over experts, each
    taking ``act(x @ Wg[e]) * (x @ Wi[e]) @ Wo[e]`` on its contiguous rows
    in fp32 (the JAX package's per-row gather would hold N x D x F values).
    Reads the group offsets back to the host (``group_ends``).  Returns (N,
    D) float32."""
    n, d = xs.shape
    f32 = torch.float32
    out = torch.zeros((n, d), dtype=f32, device=xs.device)
    lo = 0
    for e, end in enumerate(group_ends(group_sizes, n)):
        hi = min(int(end), n)
        if hi > lo:
            x = xs[lo:hi].to(f32)
            h = ACTS[act](x @ w_gate[e].to(f32)) * (x @ w_in[e].to(f32))
            out[lo:hi] = h @ w_out[e].to(f32)
        lo = max(lo, hi)
    return out


def grouped_ffn_bwd_ref(xs, group_sizes, w_gate, w_in, w_out, grad_out, *, act="silu"):
    """The gradient of ``grouped_ffn_ref`` given ``grad_out`` (N, D): the
    JAX package's ``custom_vjp`` backward (``grouped_expert.py``
    ``_diff_bwd``) in fp32, with its per-row gather of the weights ((N, D,
    F) values) replaced by a loop over the experts' contiguous row slices.
    Rows at or past sum(group_sizes) get a zero gradient and an empty
    expert zero weight gradients.  Returns (dx, dw_gate, dw_in, dw_out) in
    the inputs' dtypes.  Each expert's weight gradients come from its own
    row segment alone, so each is computed in fp32 and cast straight into
    a buffer of the weight's dtype: the bits of casting a whole fp32
    gradient at the end, without holding one (3 x 17.9 GB for an Arctic
    layer)."""
    n, d = xs.shape
    f32 = torch.float32
    dx = torch.zeros((n, d), dtype=f32, device=xs.device)
    dws = [torch.zeros(w.shape, dtype=w.dtype, device=w.device) for w in (w_gate, w_in, w_out)]
    lo = 0
    for e, end in enumerate(group_ends(group_sizes, n)):
        hi = min(int(end), n)
        if hi > lo:
            x, g = xs[lo:hi].to(f32), grad_out[lo:hi].to(f32)
            wg, wi, wo = (w[e].to(f32) for w in (w_gate, w_in, w_out))
            pre_i = x @ wi
            a, act_vjp = torch.func.vjp(ACTS[act], x @ wg)
            dh = g @ wo.T
            dpre_i = dh * a
            (dpre_g,) = act_vjp(dh * pre_i)
            dx[lo:hi] = dpre_g @ wg.T + dpre_i @ wi.T
            dws[0][e] = x.T @ dpre_g
            dws[1][e] = x.T @ dpre_i
            dws[2][e] = (a * pre_i).T @ g
        lo = max(lo, hi)
    return (dx.to(xs.dtype), *dws)


# ---------------------------------------------------------------------------
# Mamba-2 SSD (state-space duality), chunked
# ---------------------------------------------------------------------------

def _segsum(x):
    """x: (..., L) -> (..., L, L) lower-triangular inclusive segment sums:
    out[i, j] = sum_{k=j+1..i} x[k] for i >= j, -inf above the diagonal
    (masked before ``exp``, so exp gives exactly 0 there)."""
    n = x.shape[-1]
    cs = torch.cumsum(x, dim=-1)
    out = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=x.device))
    return out.masked_fill(~mask, -torch.inf)


def ssd_ref(x, dt, a_log, b_mat, c_mat, d_vec, *, chunk: int, init_state=None,
            return_state: bool = False):
    """Chunked SSD forward (Mamba-2, ngroups=1).

    x: (B, S, H, P); dt: (B, S, H) (already softplus-ed, > 0);
    a_log: (H,) (A = -exp(a_log)); b_mat, c_mat: (B, S, N); d_vec: (H,).
    h_t = exp(dt_t * A) h_{t-1} + dt_t * x_t B_t^T ;  y_t = h_t C_t + D x_t
    S must be a multiple of ``chunk``.  Every product runs in fp32; y
    rounds once to x's dtype.  The inter-chunk recurrence is a Python loop
    over chunks.  Returns y (B, S, H, P) and, with ``return_state``, the
    final state (B, H, P, N) fp32.
    """
    bsz, s, h, p = x.shape
    n = b_mat.shape[-1]
    if s % chunk:
        raise ValueError(f"ssd_ref: S={s} is not a multiple of chunk={chunk}")
    nc, cl = s // chunk, chunk
    f32 = torch.float32

    d_a = dt.to(f32) * (-torch.exp(a_log.to(f32)))[None, None, :]  # (B,S,H) log-decay
    xr = (x.to(f32) * dt.to(f32)[..., None]).reshape(bsz, nc, cl, h, p)
    d_a = d_a.reshape(bsz, nc, cl, h)
    br = b_mat.to(f32).reshape(bsz, nc, cl, n)
    cr = c_mat.to(f32).reshape(bsz, nc, cl, n)

    cums = torch.cumsum(d_a, dim=2)  # inclusive (B,NC,CL,H)
    # intra-chunk (diagonal blocks)
    decay = torch.exp(_segsum(d_a.permute(0, 1, 3, 2)))  # (B,NC,H,CL,CL)
    scores = torch.einsum("bcln,bcmn->bclm", cr, br)  # (B,NC,CL,CL)
    y_diag = torch.einsum("bchlm,bcmhp->bclhp", scores[:, :, None] * decay, xr)

    # per-chunk outgoing states
    decay_to_end = torch.exp(cums[:, :, -1:, :] - cums)  # (B,NC,CL,H)
    s_local = torch.einsum("bcln,bclhp->bchpn", br, xr * decay_to_end[..., None])

    # inter-chunk recurrence over chunk states
    chunk_decay = torch.exp(cums[:, :, -1, :])  # (B,NC,H)
    state = (torch.zeros((bsz, h, p, n), dtype=f32, device=x.device)
             if init_state is None else init_state.to(f32))
    prev = []
    for c in range(nc):
        prev.append(state)  # the state before chunk c
        state = state * chunk_decay[:, c, :, None, None] + s_local[:, c]
    s_prev = torch.stack(prev, dim=1)  # (B,NC,H,P,N)

    y_off = torch.einsum("bcln,bchpn->bclhp", cr, s_prev) * torch.exp(cums)[..., None]
    y = (y_diag + y_off).reshape(bsz, s, h, p)
    y = y + d_vec.to(f32)[None, None, :, None] * x.to(f32)
    y = y.to(x.dtype)
    if return_state:
        return y, state
    return y


def ssd_decode_ref(x, dt, a_log, b_vec, c_vec, d_vec, state):
    """One decode step.  x: (B, H, P); dt: (B, H); b_vec, c_vec: (B, N);
    state: (B, H, P, N) fp32.  Returns (y (B, H, P) in x's dtype, the new
    state)."""
    f32 = torch.float32
    d_a = torch.exp(dt.to(f32) * (-torch.exp(a_log.to(f32)))[None, :])  # (B,H)
    upd = torch.einsum("bhp,bn->bhpn", x.to(f32) * dt.to(f32)[..., None], b_vec.to(f32))
    new_state = state * d_a[..., None, None] + upd
    y = torch.einsum("bhpn,bn->bhp", new_state, c_vec.to(f32))
    y = y + d_vec.to(f32)[None, :, None] * x.to(f32)
    return y.to(x.dtype), new_state


# ---------------------------------------------------------------------------
# RG-LRU (RecurrentGemma) linear recurrence
# ---------------------------------------------------------------------------

def rglru_scan_ref(a, bx, init_state=None):
    """h_t = a_t * h_{t-1} + bx_t along S, as a log-depth doubling scan
    (the counterpart of JAX's ``associative_scan``): after the round with
    stride k, element t holds the composition of elements t-2k+1..t, and
    composing (a1, b1) then (a2, b2) gives (a1 * a2, a2 * b1 + b2).

    a, bx: (B, S, W).  Runs in fp32.  Returns (h (B, S, W) in bx's dtype,
    the final state (B, W) fp32)."""
    f32 = torch.float32
    acc_a, acc_b = a.to(f32), bx.to(f32)
    if init_state is not None:
        acc_b = acc_b.clone()
        acc_b[:, 0] += acc_a[:, 0] * init_state.to(f32)
    s, k = acc_a.shape[1], 1
    while k < s:
        new_a, new_b = acc_a.clone(), acc_b.clone()
        new_b[:, k:] = acc_a[:, k:] * acc_b[:, :-k] + acc_b[:, k:]
        new_a[:, k:] = acc_a[:, k:] * acc_a[:, :-k]
        acc_a, acc_b = new_a, new_b
        k *= 2
    return acc_b.to(bx.dtype), acc_b[:, -1]


def rglru_scan_bwd_ref(a, bx, init_state, grad_h, grad_final):
    """The gradient of ``rglru_scan_ref`` given the cotangents of h (B, S,
    W) and of the final state (B, W): the recurrence run in reverse,
    dh_t = g_t + a_{t+1} dh_{t+1} (the final state's cotangent added at the
    last step), then d bx_t = dh_t, d a_t = dh_t h_{t-1} and d init =
    a_0 dh_0.  The forward's h is recomputed in fp32 and both scans run
    through ``rglru_scan_ref``.  Returns (da, dbx, dinit) in the inputs'
    dtypes (dinit None without an ``init_state``)."""
    f32 = torch.float32
    a32 = a.to(f32)
    h, _ = rglru_scan_ref(a32, bx.to(f32), init_state)
    g = grad_h.to(f32).clone()
    g[:, -1] += grad_final.to(f32)
    a_next = torch.nn.functional.pad(a32[:, 1:], (0, 0, 0, 1))
    dh = rglru_scan_ref(a_next.flip(1), g.flip(1))[0].flip(1)
    h0 = (torch.zeros_like(h[:, :1]) if init_state is None
          else init_state.to(f32)[:, None])
    da = dh * torch.cat([h0, h[:, :-1]], dim=1)
    dinit = None if init_state is None else (a32[:, 0] * dh[:, 0]).to(init_state.dtype)
    return da.to(a.dtype), dh.to(bx.dtype), dinit
