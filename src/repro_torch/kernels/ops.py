"""Dispatch over the hand-written kernels and their plain versions.

``impl`` selects the execution path, as in the JAX package's ``kernels/ops.py``:
  - "cuda":      the hand-written Hopper kernel (the counterpart of "pallas");
                 the default of every entry point.  CPU tensors raise.
  - "reference": the plain PyTorch version (CPU tests, and the yardstick the
                 kernels are held against on the card).
Nothing switches tier by itself: a failed build or launch raises.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import (decode_attention, flash_attention, grouped_expert,
                                 paged_decode_attention, ref, varlen_attention)
from repro_torch.kernels import rglru_scan as rglru_kernel
from repro_torch.kernels import ssd_scan as ssd_kernel

IMPLS = ("reference", "cuda")
NEG_INF = ref.NEG_INF


def _check(impl, *tensors):
    if impl not in IMPLS:
        raise ValueError(f"impl={impl!r} not in {IMPLS}")
    if impl == "cuda":
        for t in tensors:
            if not t.is_cuda:
                raise ValueError(f"impl='cuda' needs CUDA tensors; got one on "
                                 f"{t.device} (use impl='reference' on the CPU)")


def mha(q, k, v, *, causal=True, window=None, q_positions=None,
        kv_positions=None, impl="cuda"):
    """GQA attention; see ``ref.mha_ref``.  Positions None means arange."""
    _check(impl, q, k, v)
    if impl == "reference":
        return ref.mha_ref(q, k, v, causal=causal, window=window,
                           q_positions=q_positions, kv_positions=kv_positions)
    return flash_attention.flash_mha(q, k, v, causal=causal, window=window,
                                     q_positions=q_positions,
                                     kv_positions=kv_positions)


def varlen_mha(q, k, v, cu_seqlens, *, causal=True, window=None, max_seqlen=None,
               impl="cuda"):
    """Packed (``cu_seqlens``) attention over one token axis; see
    ``ref.mha_varlen_ref``.  q: (T, Hq, D); k/v: (T, Hkv, D); cu_seqlens:
    (B+1,) int32.  ``max_seqlen`` bands the plain version (the reference
    tier's forward and the kernel tier's backward); the kernel ignores it.
    Differentiable on both tiers."""
    _check(impl, q, k, v, cu_seqlens)
    if impl == "reference":
        return ref.mha_varlen_ref(q, k, v, cu_seqlens, causal=causal, window=window,
                                  max_seqlen=max_seqlen)
    return varlen_attention.flash_mha_varlen(q, k, v, cu_seqlens, causal=causal,
                                             window=window, max_seqlen=max_seqlen)


def decode_mha(q, k_cache, v_cache, *, cache_len, window=None, return_lse=False,
               impl="cuda"):
    """One-token attention over a KV cache; see ``ref.decode_mha_ref``
    (``return_lse``: the fp32 rows and their log-sum-exp)."""
    _check(impl, q, k_cache, v_cache, cache_len)
    if impl == "reference":
        return ref.decode_mha_ref(q, k_cache, v_cache, cache_len=cache_len,
                                  window=window, return_lse=return_lse)
    return decode_attention.flash_decode(q, k_cache, v_cache, cache_len=cache_len,
                                         window=window, return_lse=return_lse)


def paged_decode_mha(q, k_pool, v_pool, block_table, *, cache_len, impl="cuda"):
    """One-token attention over a paged (block-pool) KV cache; see
    ``ref.paged_decode_mha_ref`` for the layout."""
    _check(impl, q, k_pool, v_pool, block_table, cache_len)
    if impl == "reference":
        return ref.paged_decode_mha_ref(q, k_pool, v_pool, block_table,
                                        cache_len=cache_len)
    return paged_decode_attention.paged_flash_decode(
        q, k_pool, v_pool, block_table, cache_len=cache_len)


def paged_verify_mha(q, k_pool, v_pool, block_table, *, q_positions, impl="cuda"):
    """Multi-query (speculative verify) attention over a paged KV cache; see
    ``ref.paged_verify_mha_ref``.  q: (B, K, Hq, D); q_positions: (B, K).
    The kernel tier does what the JAX package's kernel tier does: it
    gathers the table's block rows (a plain indexing op) and runs
    ``flash_mha`` with explicit positions, query positions against the
    gathered slots' arange, so causal masking by position hides every
    unwritten slot."""
    _check(impl, q, k_pool, v_pool, block_table, q_positions)
    if impl == "reference":
        return ref.paged_verify_mha_ref(q, k_pool, v_pool, block_table,
                                        q_positions=q_positions)
    kv_positions = torch.arange(block_table.shape[1] * k_pool.shape[1],
                                device=q.device)[None]
    return flash_attention.flash_mha(
        q.contiguous(), ref.gather_pool(k_pool, block_table),
        ref.gather_pool(v_pool, block_table), causal=True,
        q_positions=q_positions, kv_positions=kv_positions)


def grouped_ffn(xs, group_sizes, w_gate, w_in, w_out, *, act="silu", impl="cuda"):
    """Grouped gated expert FFN over expert-sorted rows (dropless MoE); see
    ``ref.grouped_ffn_ref``.  Returns (N, D) float32 on every tier: the
    combine caller casts once.  Row i's result depends only on row i and
    its expert's weights, so a token gets the same value in any cohort.
    Both tiers differentiate through ``ref.grouped_ffn_bwd_ref``."""
    _check(impl, xs, group_sizes, w_gate, w_in, w_out)
    if impl == "reference":
        return grouped_expert.grouped_ffn_plain(xs, group_sizes, w_gate, w_in, w_out, act=act)
    return grouped_expert.grouped_ffn(xs, group_sizes, w_gate, w_in, w_out, act=act)


def ssd(x, dt, a_log, b_mat, c_mat, d_vec, *, chunk, init_state=None,
        return_state=False, impl="cuda"):
    """Mamba-2 SSD chunked scan; see ``ref.ssd_ref``.  The kernel tier, like
    the JAX package's Pallas tier, takes no ``init_state`` (it raises)."""
    _check(impl, x, dt, a_log, b_mat, c_mat, d_vec)
    if impl == "reference":
        return ref.ssd_ref(x, dt, a_log, b_mat, c_mat, d_vec, chunk=chunk,
                           init_state=init_state, return_state=return_state)
    return ssd_kernel.ssd_scan(x, dt, a_log, b_mat, c_mat, d_vec, chunk=chunk,
                               init_state=init_state, return_state=return_state)


# lint: allow(impl-dispatch) -- no kernel in either package: plain PyTorch on every tier
def ssd_decode(x, dt, a_log, b_vec, c_vec, d_vec, state):
    """One SSD decode step (no kernel in the JAX package either: an
    O(H*P*N) elementwise update, plain PyTorch on every tier)."""
    return ref.ssd_decode_ref(x, dt, a_log, b_vec, c_vec, d_vec, state)


def rglru_scan(a, bx, init_state=None, *, impl="cuda"):
    """RG-LRU recurrence; see ``ref.rglru_scan_ref``.  Returns (h, final
    state).  The kernel tier takes no ``init_state`` (it raises)."""
    _check(impl, a, bx)
    if impl == "reference":
        return ref.rglru_scan_ref(a, bx, init_state)
    return rglru_kernel.rglru_scan(a, bx, init_state)


# ---------------------------------------------------------------- sampling
# V-reductions with no kernel in the JAX package either: plain PyTorch on
# every tier.

def _cdf_chunk(v: int) -> int:
    """Largest power-of-two chunk <= 1024 that divides V (0 = no chunking)."""
    k = 1024
    while k > 1:
        if v % k == 0 and v >= 2 * k:
            return k
        k //= 2
    return 0


def _sample_cdf(scaled, u01):
    """Two-level inverse-CDF sample from (tempered/truncated) logits, one
    uniform per row: ``u01`` (B, 1) in [0, 1).  Pass 1 sums exp per chunk,
    the chunk CDF picks a chunk, and only that chunk gets an exact
    intra-chunk cumsum.  Returns (token (B,) int32, logsumexp(scaled))."""
    b, v = scaled.shape
    m = scaled.amax(dim=-1, keepdim=True)
    k = _cdf_chunk(v)
    if k == 0:  # odd vocab sizes: flat CDF
        c = torch.cumsum(torch.exp(scaled - m), dim=-1)
        z = c[:, -1:]
        tok = (c < u01 * z).sum(dim=-1)
        return (tok.clamp(max=v - 1).to(torch.int32),
                m[:, 0] + torch.log(z[:, 0]))
    lgc = scaled.reshape(b, v // k, k)
    chunk = torch.exp(lgc - m[:, :, None]).sum(dim=-1)  # (B, V/k)
    cchunk = torch.cumsum(chunk, dim=-1)
    z = cchunk[:, -1:]
    u = u01 * z
    ci = (cchunk < u).sum(dim=-1).clamp(max=v // k - 1)
    prev = cchunk.gather(-1, (ci - 1).clamp(min=0)[:, None])[:, 0]
    base = torch.where(ci > 0, prev, torch.zeros_like(prev))
    sel = lgc.gather(1, ci[:, None, None].expand(b, 1, k))[:, 0]  # (B, k)
    cin = torch.cumsum(torch.exp(sel - m), dim=-1)
    off = ((base[:, None] + cin) < u).sum(dim=-1).clamp(max=k - 1)
    tok = (ci * k + off).to(torch.int32)
    return tok, m[:, 0] + torch.log(z[:, 0])


def _truncate_logits(scaled, top_k: int, top_p: float):
    """Mask (tempered) logits outside the top-k / nucleus top-p set to
    NEG_INF.  Top-p always keeps the most likely token; ties at the cutoff
    are kept."""
    v = scaled.shape[-1]
    if top_k and top_k < v:
        kth = torch.topk(scaled, top_k, dim=-1).values[:, -1:]
        scaled = torch.where(scaled < kth, NEG_INF, scaled)
    if top_p < 1.0:
        srt = torch.sort(scaled, dim=-1, descending=True).values
        e = torch.exp(srt - srt[:, :1])
        z = e.sum(dim=-1, keepdim=True)
        cdf_excl = (torch.cumsum(e, dim=-1) - e) / z  # mass strictly above
        cnt = (cdf_excl < top_p).sum(dim=-1, keepdim=True)  # >= 1
        thr = srt.gather(-1, cnt - 1)
        scaled = torch.where(scaled < thr, NEG_INF, scaled)
    return scaled


# lint: allow(impl-dispatch) -- every tier runs the plain PyTorch body (no kernel)
def sample_logits(logits, rng=None, *, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 1.0, impl="cuda",
                  uniforms=None):
    """Fused sampling + logprob extraction from decode logits.

    logits: (B, V) or (B, K, V).  ``rng``: a ``torch.Generator`` on the
    logits' device, or None for greedy.  ``uniforms`` ((rows, 1) in [0, 1))
    replaces the generator's draw, so a test can feed the JAX sampler's
    uniforms.  Returns (token int32, logprob f32) of shape (B,)/(B, K); the
    logprob is under the untempered, untruncated distribution (the PPO
    convention).  ``top_k`` (0 = off) and ``top_p`` (1.0 = off) truncate
    the sampling distribution only.  Sampling is the JAX package's default
    two-level CDF sampler (``_sample_cdf``)."""
    _check(impl)
    if top_k < 0 or not 0.0 < top_p <= 1.0:
        raise ValueError(f"bad truncation top_k={top_k} top_p={top_p}")
    lg = logits.to(torch.float32)
    lead = lg.shape[:-1]
    lg = lg.reshape(-1, lg.shape[-1])
    truncated = bool(top_k and top_k < lg.shape[-1]) or top_p < 1.0
    lse = None
    if rng is None and uniforms is None:
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
    else:
        scaled = lg if temperature == 1.0 else lg / max(temperature, 1e-6)
        if truncated:
            scaled = _truncate_logits(scaled, top_k, top_p)
        if uniforms is None:
            uniforms = torch.rand((lg.shape[0], 1), generator=rng,
                                  device=lg.device)
        tok, lse_scaled = _sample_cdf(scaled, uniforms.to(lg.device))
        if temperature == 1.0 and not truncated:
            lse = lse_scaled  # reuse the sampler's partition function
    if lse is None:
        lse = torch.logsumexp(lg, dim=-1)
    lp = lg.gather(-1, tok[:, None].long())[:, 0] - lse
    return tok.reshape(lead), lp.reshape(lead)


# lint: allow(impl-dispatch) -- every tier runs the plain PyTorch body (no kernel)
def spec_verify(logits, draft_tokens, draft_logits, rng=None, *, temperature: float = 1.0,
                top_k: int = 0, top_p: float = 1.0, impl="cuda", uniforms=None):
    """Batched rejection sampling for speculative decoding, as the JAX
    package's ``spec_verify``.

    logits: (B, K+1, V) target logits at the verify positions (position i
    scores draft token i for i < K; position K is the bonus distribution);
    draft_tokens: (B, K) the draft's proposals; draft_logits: (B, K, V) the
    draft logits they were drawn from.  Returns accept_len (B,) int32 (the
    leading draft tokens accepted, in [0, K]), token (B,) int32 (the
    committed correction or bonus token), token_lp (B,) f32 (its target
    logprob) and draft_lps (B, K) f32 (the target logprob of every draft
    token; the first accept_len are the committed prefix's).

    Greedy (``rng`` and ``uniforms`` None): accept while the draft token is
    the target's argmax, then commit the argmax.  Sampled: draft token i is
    accepted with probability min(1, p(x_i) / q(x_i)) under the sampling
    distributions (temperature, top-k, top-p on both); the first rejection
    resamples from the normalised residual max(0, p - q), a clean sweep
    samples the bonus position from p.  ``uniforms`` = (u_accept (B, K),
    u_resid (B, 1)) in [0, 1) replaces the generator's two draws, so a test
    can feed the JAX package's.  Logprobs are under the untempered,
    untruncated target distribution (the PPO convention).  A set of
    V-reductions on every tier: no JAX tier has a kernel for it either."""
    _check(impl)
    if top_k < 0 or not 0.0 < top_p <= 1.0:
        raise ValueError(f"bad truncation top_k={top_k} top_p={top_p}")
    b, k1, v = logits.shape
    k = k1 - 1
    if (k < 1 or tuple(draft_tokens.shape) != (b, k)
            or tuple(draft_logits.shape) != (b, k, v)):
        raise ValueError(f"shape mismatch: logits {tuple(logits.shape)}, draft_tokens "
                         f"{tuple(draft_tokens.shape)}, draft_logits "
                         f"{tuple(draft_logits.shape)}")
    lg = logits.to(torch.float32)
    dt = draft_tokens.long()
    lse = torch.logsumexp(lg, dim=-1)  # (B, K+1)
    draft_lps = lg[:, :k].gather(-1, dt[..., None])[..., 0] - lse[:, :k]

    if rng is None and uniforms is None:
        tgt = torch.argmax(lg, dim=-1)  # (B, K+1)
        ok = dt == tgt[:, :k]
        accept_len = torch.cumprod(ok.to(torch.int32), dim=-1).sum(dim=-1)
        token = tgt.gather(1, accept_len[:, None])[:, 0]
    else:
        def scaled(x):
            s = x if temperature == 1.0 else x / max(temperature, 1e-6)
            if bool(top_k and top_k < v) or top_p < 1.0:
                s = _truncate_logits(s.reshape(-1, v), top_k, top_p).reshape(s.shape)
            return s

        pt, qt = scaled(lg), scaled(draft_logits.to(torch.float32))
        lp_p = (pt[:, :k].gather(-1, dt[..., None])[..., 0]
                - torch.logsumexp(pt[:, :k], dim=-1))
        lp_q = qt.gather(-1, dt[..., None])[..., 0] - torch.logsumexp(qt, dim=-1)
        if uniforms is None:
            u_acc = torch.rand((b, k), generator=rng, device=lg.device)
            u_res = torch.rand((b, 1), generator=rng, device=lg.device)
        else:
            u_acc, u_res = (u.to(device=lg.device, dtype=torch.float32) for u in uniforms)
        ok = torch.log(torch.clamp(u_acc, min=1e-38)) < lp_p - lp_q
        accept_len = torch.cumprod(ok.to(torch.int32), dim=-1).sum(dim=-1)
        rows = torch.arange(b, device=lg.device)
        p_probs = torch.softmax(pt[rows, accept_len], dim=-1)  # (B, V)
        q_probs = torch.softmax(qt[rows, accept_len.clamp(max=k - 1)], dim=-1)
        q_probs = torch.where((accept_len < k)[:, None], q_probs, 0.0)
        resid = torch.clamp(p_probs - q_probs, min=0.0)
        # fp guard: where p == q to rounding the residual mass underflows;
        # sample the target distribution then (the exact limit)
        mass = resid.sum(dim=-1, keepdim=True)
        resid = torch.where(mass > 0.0, resid, p_probs)
        token, _ = _sample_cdf(
            torch.where(resid > 0.0, torch.log(torch.clamp(resid, min=1e-38)), NEG_INF),
            u_res)
        token = token.long()

    rows = torch.arange(b, device=lg.device)
    token_lp = lg[rows, accept_len, token] - lse[rows, accept_len]
    return accept_len.to(torch.int32), token.to(torch.int32), token_lp, draft_lps
