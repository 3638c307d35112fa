"""The port's attention kernels' plain versions against the JAX package's
oracles on the same numpy inputs (grids shared with ``test_torch_cuda.py``,
which holds the CUDA kernels against these plain versions on the card).

Rows with no valid key (a query whose every key is masked; a decode row
with cache_len 0) follow ``ref.py``: NEG_INF = -2^30 is finite, so such a
row is the uniform average over all keys.  The CUDA kernels hold the same
behaviour (explicit positions; decode), checked on the card by
``test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import decode_attention, flash_attention, ops
from repro_torch.kernels import ref as tref
from test_torch_cuda import DECODE_GRID, MHA_GRID

TOL = {"float32": 2e-6, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _inputs(seed, shapes, dtype):
    """The same normal draws for both sides, rounded to ``dtype`` once."""
    rng = np.random.default_rng(seed)
    xs = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
    tx = [torch.from_numpy(x).to(TDT[dtype]) for x in xs]
    jx = [jnp.asarray(t.float().numpy()).astype(JDT[dtype]) for t in tx]
    return jx, tx


def _close(out_t, out_j, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(out_t.float().numpy(),
                               np.asarray(out_j, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,hq,hkv,d,causal,window", MHA_GRID)
def test_mha_ref_matches_jax(b, s, hq, hkv, d, causal, window, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        0, [(b, s, hq, d), (b, s, hkv, d), (b, s, hkv, d)], dtype)
    want = jref.mha_ref(jq, jk, jv, causal=causal, window=window)
    _close(tref.mha_ref(tq, tk, tv, causal=causal, window=window), want, dtype)
    # the kernel's wrapper takes its plain version on CPU tensors
    _close(flash_attention.flash_mha(tq, tk, tv, causal=causal, window=window),
           want, dtype)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("hq,hkv", [(14, 2), (4, 4)])
def test_mha_ref_explicit_positions_match_jax(hq, hkv, window):
    """Explicit positions (a ring linearised by position tags, as the
    verify path builds them), including keys tagged 2^30 that every query
    masks and a query row whose keys are all masked."""
    b, sq, skv, d = 2, 5, 24, 16
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        1, [(b, sq, hq, d), (b, skv, hkv, d), (b, skv, hkv, d)], "float32")
    rng = np.random.default_rng(2)
    kv_pos = np.stack([rng.permutation(skv) + 3 for _ in range(b)]).astype(np.int32)
    kv_pos[:, :4] = 2 ** 30  # never written
    q_pos = np.stack([np.arange(sq) + 17, np.arange(sq) + 2]).astype(np.int32)
    q_pos[1, 0] = 1  # below every key position: no valid key in this row
    want = jref.mha_ref(jq, jk, jv, causal=True, window=window,
                        q_positions=jnp.asarray(q_pos),
                        kv_positions=jnp.asarray(kv_pos))
    got = ops.mha(tq, tk, tv, causal=True, window=window,
                  q_positions=torch.from_numpy(q_pos),
                  kv_positions=torch.from_numpy(kv_pos), impl="reference")
    _close(got, want, "float32")
    # the fully masked row is the uniform average over all keys
    avg = tv[1].float().mean(dim=0).repeat_interleave(hq // hkv, dim=0)
    np.testing.assert_allclose(got[1, 0].numpy(), avg.numpy(), atol=2e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,cap,hq,hkv,d,window,lens", DECODE_GRID)
def test_decode_mha_ref_matches_jax(b, cap, hq, hkv, d, window, lens, dtype):
    (jq, jk, jv), (tq, tk, tv) = _inputs(
        3, [(b, hq, d), (b, cap, hkv, d), (b, cap, hkv, d)], dtype)
    lens = np.asarray(lens, np.int32)
    want = jref.decode_mha_ref(jq, jk, jv, cache_len=jnp.asarray(lens),
                               window=window)
    cl = torch.from_numpy(lens)
    _close(tref.decode_mha_ref(tq, tk, tv, cache_len=cl, window=window), want, dtype)
    _close(decode_attention.flash_decode(tq, tk, tv, cache_len=cl, window=window),
           want, dtype)


def test_cuda_impl_on_cpu_tensors_raises():
    q = torch.zeros(1, 4, 2, 16)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        ops.mha(q, q, q)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        ops.decode_mha(q[:, 0], q, q, cache_len=torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="impl="):
        ops.mha(q, q, q, impl="pallas")
