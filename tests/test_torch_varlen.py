"""The port's packed layout and varlen attention against the JAX package on
the same numpy inputs: ``data/packing.py``, ``ref.mha_varlen_ref`` (held to
the JAX oracle, banded and not, and to the JAX Pallas kernel in interpret
mode on the valid region), the no-leakage property, and the gradient of
``varlen_attention.flash_mha_varlen`` (an autograd.Function whose CPU
forward is the plain version and whose backward is the plain version's
gradient).  The CUDA kernel itself is held on the card by
``test_torch_cuda.py`` and ``chip_smoke.py``.

Tolerances: fp32 attention 2e-6 (both sides compute the same fp32 scores
and softmax; only the einsum summation order differs); bf16 2e-2 (the
JAX package's bf16 tolerance); packing is exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.data import packing as jpacking
from repro.kernels import ref as jref
from repro.kernels.varlen_attention import flash_mha_varlen as jflash_varlen
from repro_torch.data import packing as tpacking
from repro_torch.kernels import ops, varlen_attention
from repro_torch.kernels import ref as tref

TOL = {"float32": 2e-6, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

LENGTH_MIXES = [
    pytest.param([3, 12, 1, 7], id="long-tail"),
    pytest.param([1, 1, 1, 1], id="all-len-1"),
    pytest.param([6, 6, 6, 6], id="all-equal"),
    pytest.param([12], id="single-max"),
]

# (lens, T (past sum(lens): a phantom tail), Hq, Hkv, D, causal, window):
# T > 128 runs the banded oracle over several query chunks
VARLEN_CASES = [
    ([3, 12, 1, 7], 32, 4, 2, 16, True, None),
    ([1, 70, 3, 90, 1, 40], 256, 14, 2, 16, True, None),
    ([1, 70, 3, 90, 1, 40], 256, 4, 1, 16, True, 20),
    ([130, 1, 61], 200, 4, 4, 32, True, None),
    ([9, 30, 5], 48, 4, 2, 16, False, None),
]


def _qkv(seed, t, hq, hkv, d, dtype):
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s, dtype=np.float32) for s in ((t, hq, d), (t, hkv, d), (t, hkv, d))]
    tx = [torch.from_numpy(x).to(TDT[dtype]) for x in xs]
    jx = [jnp.asarray(x.float().numpy()).astype(JDT[dtype]) for x in tx]
    return jx, tx


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


# ------------------------------------------------------------ packing

@pytest.mark.parametrize("lens", LENGTH_MIXES)
def test_pack_unpack_match_jax(lens):
    rng = np.random.default_rng(0)
    s = max(lens)
    x = rng.standard_normal((len(lens), s, 3)).astype(np.float32)
    jp = jpacking.pack(jnp.asarray(x), lens)
    tp = tpacking.pack(torch.from_numpy(x), lens)
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    back = tpacking.unpack(tp, lens, s, pad_value=-1.0)
    np.testing.assert_array_equal(back.numpy(),
                                  np.asarray(jpacking.unpack(jp, lens, s, pad_value=-1.0)))
    np.testing.assert_array_equal(tpacking.positions_of(lens), jpacking.positions_of(lens))
    np.testing.assert_array_equal(tpacking.cu_seqlens_of(lens), jpacking.cu_seqlens_of(lens))
    total = sum(lens) + 5  # phantoms get segment B
    np.testing.assert_array_equal(
        tpacking.segment_ids_of(torch.from_numpy(tpacking.cu_seqlens_of(lens)), total).numpy(),
        np.asarray(jpacking.segment_ids_of(jpacking.cu_seqlens_of(lens), total)))


def test_packed_batch_and_pad_to_match_jax():
    toks = np.arange(12, dtype=np.int32).reshape(3, 4)
    tb = tpacking.pack_batch(torch.from_numpy(toks), [2, 4, 1])
    jb = jpacking.pack_batch(jnp.asarray(toks), [2, 4, 1])
    assert tb.total_tokens == 7 and tb.n_seqs == 3 and tb.max_len == jb.max_len == 4
    tpad, jpad = tpacking.pad_to(tb, 16, pad_id=9), jpacking.pad_to(jb, 16, pad_id=9)
    for name in ("tokens", "cu_seqlens", "positions"):
        np.testing.assert_array_equal(getattr(tpad, name).numpy(),
                                      np.asarray(getattr(jpad, name)))
    assert tpad.tokens.dtype == tpad.positions.dtype == tpad.cu_seqlens.dtype == torch.int32
    assert tpacking.bucket_total(65) == jpacking.bucket_total(65) == 128
    with pytest.raises(ValueError):
        tpacking.cu_seqlens_of([3, 0])


@pytest.mark.parametrize("lens,nmb,bucket", [([3, 12, 1, 5], 2, 16), ([16, 16, 16, 16], 4, 64),
                                             ([1, 16, 2, 9, 1, 1], 3, 8)])
def test_pack_minibatches_matches_jax(lens, nmb, bucket):
    rng = np.random.default_rng(1)
    b, s = len(lens), 16
    toks = rng.integers(1, 500, (b, s)).astype(np.int32)
    valid = np.arange(s)[None] < np.asarray(lens)[:, None]
    cols = {"mask": (valid & (rng.random((b, s)) > 0.3)).astype(np.float32),
            "adv": (rng.standard_normal((b, s)) * valid).astype(np.float32)}
    jout = jpacking.pack_minibatches(jnp.asarray(toks),
                                     {k: jnp.asarray(v) for k, v in cols.items()},
                                     lens, nmb, bucket=bucket)
    tout = tpacking.pack_minibatches(torch.from_numpy(toks),
                                     {k: torch.from_numpy(v) for k, v in cols.items()},
                                     lens, nmb, bucket=bucket)
    assert set(tout) == set(jout)
    for k in jout:
        np.testing.assert_array_equal(tout[k].numpy(), np.asarray(jout[k]), err_msg=k)
    assert tout["tokens"].shape[1] % bucket == 0


@pytest.mark.parametrize("max_seqlen", [4, 11])
def test_pack_minibatches_rejects_an_understated_max_seqlen(max_seqlen):
    """A sequence longer than the band the train step's attention is given
    raises; the banded plain version would silently differentiate another
    function."""
    toks = torch.arange(4 * 16, dtype=torch.int32).reshape(4, 16)
    with pytest.raises(ValueError, match="exceeds max_seqlen"):
        tpacking.pack_minibatches(toks, {}, [3, 12, 1, 5], 2, bucket=16,
                                  max_seqlen=max_seqlen)


@pytest.mark.parametrize("lens,nmb", [([3, 12, 1, 2], 2), ([16, 16, 16, 16], 4)])
def test_pack_minibatches_packs_as_before_under_the_true_bound(lens, nmb):
    """With the longest length as ``max_seqlen`` the output is the unchecked
    one, key for key; the first case's second minibatch has a 13-token
    phantom tail, longer than that bound, and is exempt."""
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(1, 500, (len(lens), 16)).astype(np.int32))
    cols = {"adv": torch.from_numpy(rng.standard_normal((len(lens), 16)).astype(np.float32))}
    want = tpacking.pack_minibatches(toks, cols, lens, nmb, bucket=16)
    got = tpacking.pack_minibatches(toks, cols, lens, nmb, bucket=16, max_seqlen=max(lens))
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@settings(max_examples=25, deadline=None)
@given(st.data())
def test_pack_roundtrip_property(data):
    """Random partitions: pack then unpack is the identity on the valid
    region and pad elsewhere, equal to the JAX package's, and a masked sum
    is the same in both layouts."""
    b = data.draw(st.integers(1, 6))
    s = data.draw(st.integers(1, 16))
    lens = np.asarray([data.draw(st.integers(1, s)) for _ in range(b)])
    rng = np.random.default_rng(data.draw(st.integers(0, 10**6)))
    x = rng.standard_normal((b, s)).astype(np.float32)
    mask = ((np.arange(s)[None] < lens[:, None]) & (rng.random((b, s)) > 0.3)).astype(np.float32)
    xp = tpacking.pack(torch.from_numpy(x), lens)
    np.testing.assert_array_equal(xp.numpy(), np.asarray(jpacking.pack(jnp.asarray(x), lens)))
    back = tpacking.unpack(xp, lens, s)
    valid = np.arange(s)[None] < lens[:, None]
    np.testing.assert_array_equal(back.numpy()[valid], x[valid])
    assert not back.numpy()[~valid].any()
    mp = tpacking.pack(torch.from_numpy(mask), lens)
    np.testing.assert_allclose(float((xp * mp).sum()), float((x * mask).sum()), rtol=1e-5,
                               atol=1e-5)


# ------------------------------------------------------- varlen attention

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("lens,t,hq,hkv,d,causal,window", VARLEN_CASES)
def test_mha_varlen_ref_matches_jax(lens, t, hq, hkv, d, causal, window, dtype):
    """Every row, phantoms included, without and with the band."""
    (jq, jk, jv), (tq, tk, tv) = _qkv(0, t, hq, hkv, d, dtype)
    cu = tpacking.cu_seqlens_of(lens)
    band = max(max(lens), t - sum(lens))
    for ms in (None, band):
        want = jref.mha_varlen_ref(jq, jk, jv, jnp.asarray(cu), causal=causal, window=window,
                                   max_seqlen=ms)
        got = tref.mha_varlen_ref(tq, tk, tv, torch.from_numpy(cu), causal=causal,
                                  window=window, max_seqlen=ms)
        _close(got, want, dtype)
        _close(ops.varlen_mha(tq, tk, tv, torch.from_numpy(cu), causal=causal, window=window,
                              max_seqlen=ms, impl="reference"), want, dtype)


@pytest.mark.parametrize("lens,window", [([3, 12, 1, 7], None), ([7, 20, 4], 5),
                                         ([1, 1, 1, 1], None)])
def test_mha_varlen_ref_matches_jax_pallas_interpret(lens, window):
    """The JAX Pallas kernel in interpret mode on the valid region (its
    phantom rows are unspecified), fp32."""
    t = jpacking.bucket_total(sum(lens), 16)
    (jq, jk, jv), (tq, tk, tv) = _qkv(1, t, 4, 2, 16, "float32")
    cu = tpacking.cu_seqlens_of(lens)
    want = jflash_varlen(jq, jk, jv, jnp.asarray(cu), window=window, interpret=True)
    got = varlen_attention.flash_mha_varlen(tq, tk, tv, torch.from_numpy(cu), window=window,
                                            max_seqlen=max(lens))
    valid = sum(lens)
    _close(got[:valid], np.asarray(want)[:valid], "float32")
    assert torch.isfinite(got).all()


@pytest.mark.parametrize("fn", ["plain", "function"])
def test_varlen_has_no_cross_sequence_leakage(fn):
    """Perturb one sequence: every other row, phantoms included, keeps its
    bits."""
    lens = [5, 9, 3]
    (_, _, _), (q, k, v) = _qkv(2, 24, 4, 2, 16, "float32")
    cu = torch.from_numpy(tpacking.cu_seqlens_of(lens))
    call = tref.mha_varlen_ref if fn == "plain" else varlen_attention.flash_mha_varlen
    base = call(q, k, v, cu, max_seqlen=9)
    sl = slice(5, 14)
    q2, k2, v2 = q.clone(), k.clone(), v.clone()
    q2[sl] += 3.0
    k2[sl] -= 2.0
    v2[sl] *= 5.0
    pert = call(q2, k2, v2, cu, max_seqlen=9)
    keep = torch.ones(24, dtype=torch.bool)
    keep[sl] = False
    assert torch.equal(base[keep], pert[keep])
    assert not torch.equal(base[sl], pert[sl])


@pytest.mark.parametrize("window", [None, 6])
def test_varlen_function_gradients_match_plain_autograd(window):
    """The Function's dq, dk, dv against autograd straight through the
    plain version (exact: the backward is that autograd), banded over
    several query chunks with a phantom tail."""
    lens = [1, 70, 3, 90, 1, 40]
    (_, _, _), xs = _qkv(3, 256, 4, 2, 16, "float32")
    cu = torch.from_numpy(tpacking.cu_seqlens_of(lens))
    w = torch.from_numpy(np.random.default_rng(4).standard_normal((256, 4, 16),
                                                                  dtype=np.float32))
    grads = []
    for fn in (varlen_attention.flash_mha_varlen, tref.mha_varlen_ref):
        leaves = [x.clone().requires_grad_(True) for x in xs]
        out = fn(*leaves, cu, window=window, max_seqlen=90)
        (out * w).sum().backward()
        grads.append([x.grad for x in leaves])
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_varlen_function_gradcheck_float64():
    lens = [3, 7, 1]
    rng = np.random.default_rng(5)
    xs = [torch.from_numpy(rng.standard_normal(s)).requires_grad_(True)
          for s in ((13, 2, 4), (13, 1, 4), (13, 1, 4))]
    cu = torch.from_numpy(tpacking.cu_seqlens_of(lens))
    assert torch.autograd.gradcheck(
        lambda q, k, v: varlen_attention.flash_mha_varlen(q, k, v, cu, window=4, max_seqlen=7),
        xs)


def test_varlen_cuda_tier_raises_on_cpu_and_counts_no_launch():
    (_, _, _), (q, k, v) = _qkv(6, 16, 4, 2, 16, "float32")
    cu = torch.tensor([0, 9, 16], dtype=torch.int32)
    before = varlen_attention.flash_mha_varlen.launches
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        ops.varlen_mha(q, k, v, cu)
    varlen_attention.flash_mha_varlen(q, k, v, cu)  # CPU tensors: the plain version
    assert varlen_attention.flash_mha_varlen.launches == before
