"""The arithmetic of the two tensor-core designs, emulated in PyTorch on the
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
- ``decode_attention.decode_splits``, the host's choice of split count,
  on the main path's shapes.

Inputs come from numpy with a seed and go to both packages.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention

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
    b, c, hkv, d = k.shape
    hq = q.shape[1]
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
                    kt = torch.where(live[:, None], k[row, keys.clamp(max=c - 1), hk], 0.0)
                    vt = torch.where(live[:, None], v[row, keys.clamp(max=c - 1), hk], 0.0)
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
