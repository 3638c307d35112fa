"""The arithmetic of the tensor-core designs, emulated in PyTorch on the
CPU and held against the JAX package's references (``repro.kernels.ref``),
so that what the CUDA kernels compute is checked before any card runs them.

- ``flash_decode``'s split-KV grid (``csrc/decode_split.cuh``,
  ``csrc/decode_attention.cu``): each split walks whole 64-key tiles of
  its row's [0, end), keeps an unnormalised partial (max m in log2 units,
  sum l, the G x D accumulator) in fp32, and a merge combines the splits in
  order.  In fp32 it equals ``decode_mha_ref`` to 1e-6 for every split
  count: only the summation order differs.
- The bf16 kernels' P V through P's two bf16 terms (P_hi = bf16(P), P_lo =
  bf16(P - P_hi)): on the same bf16 values it stays within 2e-5 (scaled)
  of fp32 P, where a single bf16 P reads ~1e-3.
- ``grouped_ffn``'s bf16 body (``csrc/grouped_expert.cu``): exact
  products of bf16 x and weights in fp32, H split into H_hi + H_lo before
  the last product.  It holds chip_smoke.py's GROUPED_TOL (1e-4, scaled)
  against the JAX reference; one bf16 H does not (~1e-3).
- ``paged_flash_decode``'s bf16 grid: the same split walk with each key
  read through a shuffled block table (``PagedRows``), against JAX's
  ``paged_decode_mha_ref`` and bit for bit against the walk on the
  gathered cache.
- ``ssd_scan``'s bf16 body (``csrc/ssd_scan.cu``): 128-row pieces, exact
  fp32 products of the bf16 x, B and C, and M, the state and X w each
  entering a product as two bf16 terms, for each P split.  It holds 1e-4
  (scaled) against JAX's ``ssd_ref`` in fp32 on y before its bf16 rounding
  and on the state; one bf16 state or one bf16 M (the controls) does not.
- ``rglru_scan``'s chunked scan (``csrc/rglru_scan.cu``): chunks of S
  walked in fp32 FMAs from a zero carry for their aggregates, the carries
  composed in chunk order across a cluster's window and from one window to
  the next, each chunk walked again from its carry.  It holds 1e-5 (scaled)
  against JAX's ``rglru_scan_ref`` and ``rglru_pallas`` (interpret) at
  several chunk lengths, a ragged last chunk, S = 1, S shorter than a chunk
  and several windows; a chunk that skips its predecessors' carries (the
  control) does not.
- ``decode_attention.decode_splits``, ``ssd_scan.ssd_splits`` and
  ``rglru_scan.rglru_chunks``, the host's choices of split count and chunk
  length, on the main path's shapes.

Inputs come from numpy with a seed and go to both packages.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru_pallas
from repro_torch.kernels import decode_attention, rglru_scan, ssd_scan

LOG2E = 1.4426950408889634
NEG_INF = -2.0 ** 30  # kMaskedLogit: a row with no valid key averages every key
TILE = decode_attention.SPLIT_TILE
GROUPED_TOL = 1e-4  # chip_smoke.py's grouped_ffn limit in bf16


def _bf16_terms(x):
    """x as the kernels feed it to a bf16 product: (bf16(x), bf16(x - bf16(x)))."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.float()).to(torch.bfloat16)


def _pv(p, v, p_terms):
    """P V in fp32 with P as it enters the product: fp32 ("fp32"), its two
    bf16 terms ("hilo") or one bf16 term ("bf16")."""
    if p_terms == "fp32":
        return p @ v
    hi, lo = _bf16_terms(p)
    out = hi.float() @ v
    return out + lo.float() @ v if p_terms == "hilo" else out


def split_kv_decode(q, k, v, cache_len, *, window, splits, p_terms="fp32"):
    """The split-KV kernel's arithmetic: q (B, Hq, D), caches (B, C, Hkv, D),
    fp32.  Row b walks [0, end) (end = min(len, cap), or C when that is 0,
    every key then masked at NEG_INF) in 64-key tiles, ceil(tiles / splits)
    to a split; each split keeps (m, l, acc) with exp2 of log2-scaled
    logits; the merge weights split s by 2^(m_s - max m) in split order and
    divides by the merged l."""
    def fetch(row, keys, hk):
        return k[row, keys, hk], v[row, keys, hk]
    return _split_walk(q, cache_len, fetch, c=k.shape[1], hkv=k.shape[2], window=window,
                       splits=splits, p_terms=p_terms)


def paged_split_decode(q, k_pool, v_pool, table, cache_len, *, splits):
    """The paged kernel's bf16 grid: the same walk, key kj of row b read
    from pool row table[b, kj // bs] * bs + kj % bs (``PagedRows``) over
    C = M * bs slots."""
    n, bs, hkv, d = k_pool.shape
    kf, vf = k_pool.reshape(n * bs, hkv, d), v_pool.reshape(n * bs, hkv, d)

    def fetch(row, keys, hk):
        rows = table[row, keys // bs].long() * bs + keys % bs
        return kf[rows, hk], vf[rows, hk]
    return _split_walk(q, cache_len, fetch, c=table.shape[1] * bs, hkv=hkv, window=None,
                       splits=splits)


def _split_walk(q, cache_len, fetch, *, c, hkv, window, splits, p_terms="fp32"):
    """Rows of the split walk; ``fetch(row, keys, hk)`` gives the K and V
    rows of cached keys ``keys`` of batch row ``row`` (each < c)."""
    b, hq, d = q.shape
    g = hq // hkv
    cap = c if window is None else min(c, window)
    scale = LOG2E / math.sqrt(d)
    out = torch.empty_like(q)
    for row in range(b):
        limit = min(int(cache_len[row]), cap)
        end = limit if limit > 0 else c
        tiles = -(-end // TILE)
        per = -(-tiles // splits)
        for hk in range(hkv):
            qh = q[row, hk * g:(hk + 1) * g]
            parts = []
            for s in range(splits):
                t0, t1 = s * per, min(tiles, s * per + per)
                if t0 >= t1:  # past the row's end: an empty partial
                    parts.append((torch.full((g,), -math.inf), torch.zeros(g), None))
                    continue
                m, l, acc = torch.full((g,), -math.inf), torch.zeros(g), torch.zeros(g, d)
                for k0 in range(t0 * TILE, t1 * TILE, TILE):
                    keys = torch.arange(k0, k0 + TILE)
                    live = keys < end
                    kt, vt = fetch(row, keys.clamp(max=c - 1), hk)
                    kt = torch.where(live[:, None], kt, 0.0)
                    vt = torch.where(live[:, None], vt, 0.0)
                    sc = (qh @ kt.T) * scale
                    sc = torch.where(keys < limit, sc, NEG_INF)
                    sc = torch.where(live, sc, -math.inf)
                    mn = torch.maximum(m, sc.amax(-1))
                    p = torch.exp2(sc - mn[:, None])
                    alpha = torch.exp2(m - mn)
                    l = l * alpha + p.sum(-1)
                    acc = acc * alpha[:, None] + _pv(p, vt, p_terms)
                    m = mn
                parts.append((m, l, acc))
            big = torch.stack([m for m, _, _ in parts]).amax(0)
            l_all, acc_all = torch.zeros(g), torch.zeros(g, d)
            for m, l, acc in parts:
                if acc is None:
                    continue
                w = torch.exp2(m - big)
                l_all = l_all + w * l
                acc_all = acc_all + w[:, None] * acc
            out[row, hk * g:(hk + 1) * g] = acc_all / l_all[:, None]
    return out


def _decode_inputs(seed, b, c, hq, hkv, d, bf16=False):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(s, dtype=np.float32) for s in
               ((b, hq, d), (b, c, hkv, d), (b, c, hkv, d)))
    if bf16:  # values exact in bf16
        q, k, v = (torch.from_numpy(x).bfloat16().float().numpy() for x in (q, k, v))
    return q, k, v


# (C, window, lengths): a linear cache, and a ring whose rows run past its
# capacity; lengths 0 (uniform average), 1, 64, 65 (tile edges)
CACHES = [(130, None, [0, 1, 64, 65, 130]), (128, 128, [0, 1, 64, 65, 300])]


@pytest.mark.parametrize("splits", [1, 2, 3, 9])
@pytest.mark.parametrize("hq,hkv,d", [(14, 2, 64), (16, 1, 256)])  # G 7 (qwen), 16 (rg)
@pytest.mark.parametrize("c,window,lens", CACHES)
def test_split_kv_decode_matches_jax(c, window, lens, hq, hkv, d, splits):
    q, k, v = _decode_inputs(0, len(lens), c, hq, hkv, d)
    want = jref.decode_mha_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               cache_len=jnp.asarray(lens, jnp.int32), window=window)
    got = split_kv_decode(*(torch.from_numpy(x) for x in (q, k, v)),
                          torch.tensor(lens, dtype=torch.int32), window=window, splits=splits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("hq,hkv,d", [(14, 2, 64), (16, 1, 256)])
def test_p_split_into_two_bf16_terms_keeps_fp32_precision(hq, hkv, d):
    """On bf16 values, P V through P_hi and P_lo stays within 2e-5 of fp32 P
    (scaled by 1 + |out|); one bf16 P (the control) moves the output by
    more than 1e-4."""
    lens = [1, 64, 65, 200, 256]
    q, k, v = (torch.from_numpy(x) for x in _decode_inputs(1, len(lens), 256, hq, hkv, d,
                                                          bf16=True))
    cl = torch.tensor(lens, dtype=torch.int32)
    want = split_kv_decode(q, k, v, cl, window=None, splits=2)

    def err(p_terms):
        got = split_kv_decode(q, k, v, cl, window=None, splits=2, p_terms=p_terms)
        return ((got - want).abs() / (1 + want.abs())).max().item()
    assert err("hilo") <= 2e-5
    assert err("bf16") > 1e-4


def grouped_ffn_hilo(xs, group_sizes, w_gate, w_in, w_out, h_terms="hilo"):
    """The bf16 kernel's arithmetic: fp32 products of the bf16 values, H =
    silu(x Wg) * (x Wi) in fp32, then H . Wo through H's two bf16 terms
    ("hilo") or one ("bf16")."""
    n, d = xs.shape
    out = torch.zeros((n, d))
    lo = 0
    for e, size in enumerate(group_sizes.tolist()):
        hi = min(lo + size, n)
        if hi > lo:
            x = xs[lo:hi].float()
            h = torch.nn.functional.silu(x @ w_gate[e].float()) * (x @ w_in[e].float())
            h_hi, h_lo = _bf16_terms(h)
            y = h_hi.float() @ w_out[e].float()
            out[lo:hi] = y + h_lo.float() @ w_out[e].float() if h_terms == "hilo" else y
        lo = hi
    return out


def test_grouped_ffn_h_split_holds_grouped_tol():
    """Four experts (one empty) at the init's scales: the split H holds
    GROUPED_TOL against the JAX reference on the same bf16 values; a
    single bf16 H (the control) does not."""
    rng = np.random.default_rng(2)
    n, d, f, e = 96, 256, 128, 4
    sizes = [40, 0, 31, 25]
    xs = rng.standard_normal((n, d), dtype=np.float32)
    ws = (rng.standard_normal((e, d, f), dtype=np.float32) * d ** -0.5,
          rng.standard_normal((e, d, f), dtype=np.float32) * d ** -0.5,
          rng.standard_normal((e, f, d), dtype=np.float32) * f ** -0.5)
    t = [torch.from_numpy(a).bfloat16() for a in (xs, *ws)]
    gs = torch.tensor(sizes, dtype=torch.int32)
    want = np.asarray(jref.grouped_ffn_ref(
        *(jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in t[:1]),
        jnp.asarray(sizes, jnp.int32),
        *(jnp.asarray(a.float().numpy()).astype(jnp.bfloat16) for a in t[1:])))

    def err(h_terms):
        got = grouped_ffn_hilo(t[0], gs, *t[1:], h_terms=h_terms).numpy()
        return (np.abs(got - want) / (1 + np.abs(want))).max()
    assert err("hilo") <= GROUPED_TOL
    assert err("bf16") > GROUPED_TOL


# (B, Hkv, cap, SMs) -> splits: recurrentgemma-9b's decode (B 8, one KV head,
# the 576-slot ring) and qwen2-0.5b's (B 8, 2 KV heads, C 1088) on the
# H100's 132 SMs, a 16-row PPO rollout (C 384), a card with half the SMs,
# a large batch, and a cache of one tile
SPLITS = [((8, 1, 576, 132), 9), ((8, 2, 1088, 132), 17), ((16, 2, 384, 132), 6),
          ((8, 2, 1088, 66), 9), ((64, 2, 1088, 132), 3), ((8, 2, 64, 132), 1),
          ((256, 2, 1088, 132), 1)]


@pytest.mark.parametrize("shape,want", SPLITS)
def test_decode_splits_on_the_main_path_shapes(shape, want):
    b, hkv, cap, sms = shape
    got = decode_attention.decode_splits(b, hkv, cap, sms)
    assert got == want
    assert 1 <= got <= -(-cap // TILE)


@pytest.mark.parametrize("splits", [1, 3, "decode_splits"])
@pytest.mark.parametrize("bs", [8, 16, 24])
def test_paged_split_walk_matches_jax(bs, splits):
    """Five rows (lengths 0, 1, 64, 65, M * bs) of qwen2-0.5b's heads over a
    shuffled pool, the table past each live prefix pointed at block 0
    poisoned with +-1e4: the walk through the table equals JAX's
    ``paged_decode_mha_ref`` to 1e-6 (relative 1e-5: the length-0 row
    averages every slot, the poisoned 1e4s too, where fp32's spacing is
    1e-3) and, bit for bit, the same walk over the gathered cache.  bs 24
    does not divide the 64-key tile."""
    hq, hkv, d, m = 14, 2, 64, 144 // bs
    lens = [0, 1, 64, 65, m * bs]
    b, n = len(lens), 1 + len(lens) * m
    rng = np.random.default_rng(bs)
    q = rng.standard_normal((b, hq, d), dtype=np.float32)
    kp, vp = (rng.standard_normal((n, bs, hkv, d), dtype=np.float32) for _ in range(2))
    kp[0], vp[0] = 1e4, -1e4
    table = (rng.permutation(n - 1) + 1).reshape(b, m).astype(np.int32)
    live = np.arange(m)[None] < (np.array(lens)[:, None] + bs - 1) // bs
    table = np.where(live, table, 0).astype(np.int32)
    if splits == "decode_splits":
        splits = decode_attention.decode_splits(b, hkv, m * bs, 132)
    want = jref.paged_decode_mha_ref(jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
                                     jnp.asarray(table), cache_len=jnp.asarray(lens, jnp.int32))
    q, kp, vp, tbl = (torch.from_numpy(x) for x in (q, kp, vp, table))
    cl = torch.tensor(lens, dtype=torch.int32)
    got = paged_split_decode(q, kp, vp, tbl, cl, splits=splits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=1e-5)
    gathered = [p[tbl.long()].reshape(b, m * bs, hkv, d) for p in (kp, vp)]
    assert torch.equal(got, split_kv_decode(q, *gathered, cl, window=None, splits=splits))


SSD_PIECE = 128  # rows of a piece of the bf16 body
SSD_TOL = 1e-4   # chip_smoke.py's FP32_SCAN_TOL


def _terms(x, terms):
    """x as it enters a product: fp32, two bf16 terms ("hilo") or one."""
    if terms == "fp32":
        return [x]
    hi, lo = _bf16_terms(x)
    return [hi.float(), lo.float()] if terms == "hilo" else [hi.float()]


def ssd_tc(x, dt, a_log, bm, cm, d, *, p_splits=1, m_terms="hilo", state_terms="hilo",
           xw_terms="hilo"):
    """The bf16 body's arithmetic in fp32 on bf16 values: x (B, S, H, P), B
    and C (B, S, N), dt (B, S, H).  Per (row, head, P split), 128-row
    pieces (rows past S zero, dt 0): cum = cumsum(dt A), S = C B^T, M = S
    exp(cum_t - cum_i) dt_i (t >= i; one exp2 of (cum_t - cum_i) log2(e) +
    log2(dt_i)), y = exp(cum_t) C state^T + M X + D x,
    state = exp(cum_last) state + (X w)^T B with w_i = dt_i exp(cum_last -
    cum_i); M, the state and X w enter their products as two bf16 terms.
    Returns y before its bf16 rounding and the final state (B, H, P, N)."""
    bsz, s, h, p = x.shape
    n = bm.shape[-1]
    pb = p // p_splits
    y, final = torch.zeros(bsz, s, h, p), torch.zeros(bsz, h, p, n)
    tri = torch.tril(torch.ones(SSD_PIECE, SSD_PIECE, dtype=torch.bool))
    for row in range(bsz):
        for hd in range(h):
            a = -torch.exp(a_log[hd])
            for ps in range(p_splits):
                cols = slice(ps * pb, (ps + 1) * pb)
                st = torch.zeros(pb, n)
                for t0 in range(0, s, SSD_PIECE):
                    rows = min(SSD_PIECE, s - t0)

                    def piece(t, width):
                        out = torch.zeros(SSD_PIECE, width)
                        out[:rows] = t
                        return out
                    c_, b_ = piece(cm[row, t0:t0 + rows], n), piece(bm[row, t0:t0 + rows], n)
                    x_ = piece(x[row, t0:t0 + rows, hd, cols], pb)
                    dt_ = piece(dt[row, t0:t0 + rows, hd, None], 1)[:, 0]
                    cum = torch.cumsum(dt_ * a, 0)
                    # exp(cum_t - cum_i) dt_i as the kernel forms it: one exp2
                    seg = (cum[:, None] - cum[None, :]) * LOG2E + torch.log2(dt_)[None, :]
                    m = (c_ @ b_.T) * torch.where(tri, torch.exp2(seg), 0.0)
                    acc = sum(c_ @ t.T for t in _terms(st, state_terms))
                    acc = acc * torch.exp(cum)[:, None] + sum(t @ x_ for t in _terms(m, m_terms))
                    y[row, t0:t0 + rows, hd, cols] = (acc + d[hd] * x_)[:rows]
                    xw = x_ * (dt_ * torch.exp(cum[-1] - cum))[:, None]
                    st = torch.exp(cum[-1]) * st + sum(t.T @ b_ for t in _terms(xw, xw_terms))
                final[row, hd, cols] = st
    return y, final


def _ssd_design_inputs(seed, b, s, h, p=64, n=128):
    """chip_smoke.py's SSD distributions on bf16 values: dt log-uniform in
    [1e-3, 1e-1], A in [-16, -1], D in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)

    def bf16(*shape):
        return torch.from_numpy(rng.standard_normal(shape, dtype=np.float32)).bfloat16().float()
    dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), (b, s, h))).astype(np.float32)
    a_log = rng.uniform(0.0, np.log(16.0), h).astype(np.float32)
    d = rng.uniform(0.5, 1.5, h).astype(np.float32)
    return (bf16(b, s, h, p), torch.from_numpy(dt), torch.from_numpy(a_log), bf16(b, s, n),
            bf16(b, s, n), torch.from_numpy(d))


def _scaled(got, want):
    return float((np.abs(got - want) / (1 + np.abs(want))).max())


# (S, JAX's chunk): two whole pieces; 1.5 pieces against 64-row chunks
SSD_DESIGN = [(256, 128), (192, 64)]


@pytest.mark.parametrize("p_splits", [1, 2, 4])
@pytest.mark.parametrize("s,chunk", SSD_DESIGN)
def test_ssd_tensor_core_arithmetic_matches_jax(s, chunk, p_splits):
    """y before its bf16 rounding and the final state within SSD_TOL of JAX's
    fp32 ``ssd_ref`` on the same values, for each P split."""
    args = _ssd_design_inputs(0, 2, s, 2)
    want_y, want_st = jref.ssd_ref(*(jnp.asarray(t.numpy()) for t in args), chunk=chunk,
                                   return_state=True)
    y, st = ssd_tc(*args, p_splits=p_splits)
    assert _scaled(y.numpy(), np.asarray(want_y)) <= SSD_TOL
    assert _scaled(st.numpy(), np.asarray(want_st)) <= SSD_TOL


@pytest.mark.parametrize("control", ["state", "m", "xw"])
def test_ssd_single_bf16_term_fails_the_limit(control):
    """The controls: the state (as an operand of C state^T) or M entering
    its product as one bf16 term moves y past SSD_TOL (3.4e-3, 7.5e-3 here,
    against 1.2e-5 with two terms); X w as one term moves the state."""
    args = _ssd_design_inputs(1, 1, 256, 2)
    want_y, want_st = jref.ssd_ref(*(jnp.asarray(t.numpy()) for t in args), chunk=128,
                                   return_state=True)
    y, st = ssd_tc(*args, **{f"{control}_terms": "bf16"})
    if control == "xw":
        assert _scaled(st.numpy(), np.asarray(want_st)) > SSD_TOL
    else:
        assert _scaled(y.numpy(), np.asarray(want_y)) > SSD_TOL


# (B, Hkv, M * bs, SMs) -> splits: the continuous engine's decode, 8 slots
# over 36 blocks of 16, for qwen2-0.5b (2 KV heads) and granite (8), on the
# H100's 132 SMs and on a card with half of them
PAGED_SPLITS = [((8, 2, 576, 132), 9), ((8, 8, 576, 132), 5), ((8, 8, 576, 66), 3),
                ((1, 2, 576, 132), 9)]


@pytest.mark.parametrize("shape,want", PAGED_SPLITS)
def test_paged_decode_splits_on_the_main_path_shapes(shape, want):
    assert decode_attention.decode_splits(*shape) == want


# (B, H, SMs) -> p_splits: mamba2-1.3b's admissions of 1, 2, 4 and 8 rows on
# 132 SMs, one row on half a card, and a narrow test shape
SSD_SPLITS = [((1, 64, 132), 2), ((2, 64, 132), 1), ((4, 64, 132), 1), ((8, 64, 132), 1),
              ((1, 64, 66), 1), ((1, 3, 132), 4)]


@pytest.mark.parametrize("shape,want", SSD_SPLITS)
def test_ssd_splits_on_the_main_path_shapes(shape, want):
    got = ssd_scan.ssd_splits(*shape)
    assert got == want and got in ssd_scan.P_SPLITS


# ------------------------------------------------------------- RG-LRU scan

def _fma(x, y, z):
    """fp32 fmaf(x, y, z): the product of two fp32 values is exact in
    float64, so one float64 sum rounded once to fp32 (it can part from fmaf
    in the last bit through the double rounding, far below the limit)."""
    return (x.double() * y.double() + z.double()).float()


def rglru_chunked(a, bx, *, chunk, cluster=rglru_scan.CLUSTER, handoff="chain"):
    """The kernel's arithmetic on fp32 a, bx (B, S, W): S in chunks of
    ``chunk`` steps, up to ``cluster`` chunks to a cluster, the clusters'
    windows walked in order.  Each chunk's aggregate from a zero carry (A =
    the product of its a in fp32, H = its fmaf chain), the carries composed
    in chunk order from the window's carry, carry_c = fmaf(A_{c-1},
    carry_{c-1}, H_{c-1}), each chunk walked again from its carry, and the
    next window started from the chain over all of this one's chunks.
    ``handoff="window"`` (the control) starts every chunk from its window's
    carry instead.  Returns (h, the final state)."""
    bsz, s, w = a.shape
    n = -(-s // chunk)
    g = min(cluster, n)
    h, final = torch.empty(bsz, s, w), None
    window = torch.zeros(bsz, w)
    for k in range(-(-n // g)):
        chain = window
        spans = [range(min((k * g + r) * chunk, s), min((k * g + r + 1) * chunk, s))
                 for r in range(g)]
        for steps in spans:
            big_a, big_h = torch.ones(bsz, w), torch.zeros(bsz, w)
            for t in steps:
                big_a = big_a * a[:, t]
                big_h = _fma(a[:, t], big_h, bx[:, t])
            carry = chain if handoff == "chain" else window
            for t in steps:
                carry = _fma(a[:, t], carry, bx[:, t])
                h[:, t] = carry
            if len(steps) and steps[-1] == s - 1:
                final = carry
            chain = _fma(big_a, chain, big_h)
        window = chain
    return h, final


def _rglru_design_inputs(seed, b, s, w):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.0, 1.0, (b, s, w)).astype(np.float32),
            rng.standard_normal((b, s, w)).astype(np.float32))


RGLRU_TOL = 1e-5  # chip_smoke.py's FP32_TOL

# (S, chunk): chunk lengths 1-64; whole chunks; a ragged last chunk; S = 1;
# S shorter than one chunk; S past one cluster's window (3, 2 and 17 windows)
RGLRU_DESIGN = [(64, 8), (100, 16), (1, 64), (5, 64), (200, 32), (67, 4), (257, 16),
                (129, 1)]


@pytest.mark.parametrize("s,chunk", RGLRU_DESIGN)
def test_rglru_chunked_scan_matches_jax(s, chunk):
    """h and the final state within RGLRU_TOL of JAX's ``rglru_scan_ref``
    and of ``rglru_pallas`` in interpret mode, on the same values."""
    a, bx = _rglru_design_inputs(s + chunk, 2, s, 16)
    h, final = rglru_chunked(torch.from_numpy(a), torch.from_numpy(bx), chunk=chunk)
    ja, jbx = jnp.asarray(a), jnp.asarray(bx)
    for jh, jfinal in (jref.rglru_scan_ref(ja, jbx),
                       rglru_pallas(ja, jbx, chunk=32, block_w=16, interpret=True)):
        assert _scaled(h.numpy(), np.asarray(jh)) <= RGLRU_TOL
        assert _scaled(final.numpy(), np.asarray(jfinal)) <= RGLRU_TOL


def test_rglru_chunk_without_its_predecessors_carries_fails_the_limit():
    """The control: a chunk that starts from its window's carry and not from
    the chunks before it in the window misses RGLRU_TOL by far."""
    a, bx = _rglru_design_inputs(7, 2, 100, 16)
    h, _ = rglru_chunked(torch.from_numpy(a), torch.from_numpy(bx), chunk=16,
                         handoff="window")
    want, _ = jref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(bx))
    assert _scaled(h.numpy(), np.asarray(want)) > 100 * RGLRU_TOL


# (B, S, W, SMs) -> chunk: recurrentgemma-9b's admissions (W 4096, 1-4 rows
# of 32-512 tokens) on the H100's 132 SMs, a 1-row admission on half a
# card, S = 1, and a long S that needs windows (where 64-step chunks, whose
# two stages leave one block per SM, are not taken)
RGLRU_CHUNKS = [((1, 32, 4096, 132), 8), ((1, 128, 4096, 132), 16),
                ((1, 256, 4096, 132), 32), ((1, 400, 4096, 132), 64),
                ((1, 512, 4096, 132), 64), ((2, 64, 4096, 132), 16),
                ((2, 256, 4096, 132), 32), ((2, 400, 4096, 132), 64),
                ((3, 77, 1000, 132), 16), ((4, 128, 4096, 132), 32),
                ((4, 512, 4096, 132), 64), ((1, 256, 4096, 66), 32), ((4, 1, 4096, 132), 8),
                ((1, 4096, 4096, 132), 32)]


@pytest.mark.parametrize("shape,want", RGLRU_CHUNKS)
def test_rglru_chunks_on_the_main_path_shapes(shape, want):
    """The chunk is one of CHUNKS cut to S, one window holds S wherever a
    64-step chunk or less can, and the two headline admissions give about
    2 blocks per SM or more."""
    b, s, w, sms = shape
    got = rglru_scan.rglru_chunks(*shape)
    assert got == want and got in {min(c, -(-s // 8) * 8) for c in rglru_scan.CHUNKS}
    cluster, windows = rglru_scan.rglru_grid(s, got)
    assert windows == 1 or s > rglru_scan.CLUSTER * rglru_scan.CHUNKS[-1]
    if (b, s, w) in ((1, 256, 4096), (4, 512, 4096)) and sms == 132:
        assert -(-w // rglru_scan.TILE) * cluster * b >= 1.9 * sms
