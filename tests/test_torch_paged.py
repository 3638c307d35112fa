"""The port's paged serving path against the JAX package: the block
allocator, the paged decode attention (plain version and the CPU path of the
kernel wrapper), ``paged_insert``, the paged decode step and
``ContinuousBatchServer`` in the scheduling scenarios of
``tests/test_paged.py``.

Weights are the reduced qwen2-0.5b of ``test_torch_model.make_pair`` (f32,
informative next-token distributions); inputs are made with numpy from a
seed.  Tolerances: attention 2e-6 (fp32, as ``test_paged.py``), logprobs
1e-4 (fp32 through the whole model, as ``test_torch_model.py``); greedy
tokens, schedules and pool contents are held exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.paged_decode_attention import paged_flash_decode as j_paged_flash_decode
from repro.launch import serve as jserve
from repro.models import model as JM
from repro.models import paged_cache as JPC
from repro.rlhf.experiment import ExperimentConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels.paged_decode_attention import paged_flash_decode
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.models import paged_cache as PC
from test_torch_model import make_pair

ATTN_TOL = 2e-6
TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    return make_pair(seed=2)


# ---------------------------------------------------------------- allocator

def test_allocator_invariants_and_truncate():
    a = PC.BlockAllocator(8, block_size=16)
    assert a.free_count == 7  # block 0 reserved
    ids = a.alloc(3)
    assert 0 not in ids and len(set(ids)) == 3
    assert a.used_count == 3 and a.peak == 3
    more = a.alloc(4)
    assert not set(ids) & set(more)
    assert a.free_count == 0 and a.peak == 7
    with pytest.raises(MemoryError):
        a.alloc(1)
    a.free(ids)
    assert a.free_count == 3 and a.peak == 7  # peak is a high-water mark
    with pytest.raises(ValueError):
        a.free([ids[0]])  # double free
    with pytest.raises(ValueError):
        a.free([0])  # the reserved block is never handed out
    assert set(a.alloc(3)) == set(ids)  # freed blocks are reused
    a.reset_peak()
    assert a.peak == a.used_count == 7
    kept = a.truncate_to(more, 17)  # 17 tokens need 2 of the 4 blocks
    assert kept == more[:2] and a.used_count == 5
    with pytest.raises(ValueError):
        a.truncate_to(kept, 33)  # would need 3 blocks
    assert a.truncate_to(kept, 0) == [] and a.used_count == 3
    assert [PC.needed_blocks(n, 16) for n in (1, 16, 17)] == [1, 1, 2]


def test_pool_accounting_matches_jax(pair):
    jcfg, _, tcfg, _ = pair
    assert PC.kv_pool_bytes(tcfg, 37, 16) == JPC.kv_pool_bytes(jcfg, 37, 16, jcfg.dtype)
    assert PC.full_buffer_bytes(tcfg, 8, 80) == JPC.full_buffer_bytes(
        jcfg, 8, 80, jcfg.dtype)


# ------------------------------------------------------- paged attention

def _paged_inputs(seed, b, hq, hkv, d, bs, m):
    rng = np.random.default_rng(seed)
    n = 1 + b * m
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    k_pool = rng.standard_normal((n, bs, hkv, d)).astype(np.float32)
    v_pool = rng.standard_normal((n, bs, hkv, d)).astype(np.float32)
    tbl = rng.permutation(np.arange(1, n)).reshape(b, m).astype(np.int32)  # shuffled
    return q, k_pool, v_pool, tbl


def _port_paged(q, k_pool, v_pool, tbl, lens):
    """The plain version and the kernel wrapper's CPU path, both."""
    args = [torch.from_numpy(np.ascontiguousarray(a)) for a in (q, k_pool, v_pool, tbl)]
    cl = torch.tensor(lens, dtype=torch.int32)
    a = ref.paged_decode_mha_ref(*args, cache_len=cl).numpy()
    b = paged_flash_decode(*args, cache_len=cl).numpy()
    np.testing.assert_array_equal(a, b)
    return a


@pytest.mark.parametrize("b,hq,hkv,d,bs,m,lens", [
    (3, 8, 2, 16, 8, 5, (1, 17, 40)),
    (3, 8, 2, 16, 8, 5, (8, 8, 33)),
    (2, 14, 2, 64, 16, 4, (64, 23)),   # qwen2-0.5b heads: G = 7
    (2, 4, 1, 32, 6, 7, (42, 13)),     # bs not dividing the kernel's 64-key tile
])
def test_paged_decode_matches_jax(b, hq, hkv, d, bs, m, lens):
    q, k_pool, v_pool, tbl = _paged_inputs(sum(lens), b, hq, hkv, d, bs, m)
    got = _port_paged(q, k_pool, v_pool, tbl, lens)
    jargs = [jnp.asarray(a) for a in (q, k_pool, v_pool, tbl)]
    jl = jnp.asarray(lens, jnp.int32)
    np.testing.assert_allclose(got, np.asarray(jref.paged_decode_mha_ref(*jargs, cache_len=jl)),
                               atol=ATTN_TOL)
    np.testing.assert_allclose(
        got, np.asarray(j_paged_flash_decode(*jargs, cache_len=jl, interpret=True)),
        atol=ATTN_TOL)


def test_paged_decode_masks_poisoned_scratch():
    """Table entries past the live prefix pointed at block 0, and block 0
    poisoned with +-1e4, change nothing."""
    b, hq, hkv, d, bs, m = 2, 4, 2, 16, 8, 4
    q, k_pool, v_pool, tbl = _paged_inputs(7, b, hq, hkv, d, bs, m)
    lens = (5, 11)
    base = _port_paged(q, k_pool, v_pool, tbl, lens)
    live = np.arange(m)[None, :] < PC.needed_blocks(np.array(lens)[:, None], bs)
    tbl0 = np.where(live, tbl, 0).astype(np.int32)
    k_pool[0], v_pool[0] = 1e4, -1e4
    got = _port_paged(q, k_pool, v_pool, tbl0, lens)
    np.testing.assert_allclose(got, base, atol=ATTN_TOL)
    want = jref.paged_decode_mha_ref(*(jnp.asarray(a) for a in (q, k_pool, v_pool, tbl0)),
                                     cache_len=jnp.asarray(lens, jnp.int32))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATTN_TOL)


def test_paged_decode_cache_len_zero_averages_all_slots():
    """As ``ref.py``: a row with no valid key averages all M * bs slots
    (the Pallas kernel gives zeros there; the port follows the reference)."""
    q, k_pool, v_pool, tbl = _paged_inputs(3, 2, 4, 2, 16, 8, 3)
    lens = (0, 9)
    got = _port_paged(q, k_pool, v_pool, tbl, lens)
    want = jref.paged_decode_mha_ref(*(jnp.asarray(a) for a in (q, k_pool, v_pool, tbl)),
                                     cache_len=jnp.asarray(lens, jnp.int32))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATTN_TOL)
    mean_v = v_pool[tbl[0]].reshape(-1, 2, 16).mean(axis=0)  # (Hkv, D)
    np.testing.assert_allclose(got[0], np.repeat(mean_v, 2, axis=0), atol=1e-5)


def test_paged_ops_impl_cuda_raises_on_cpu():
    q, k_pool, v_pool, tbl = (torch.from_numpy(a) for a in _paged_inputs(0, 1, 2, 1, 16, 8, 2))
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        ops.paged_decode_mha(q, k_pool, v_pool, tbl,
                             cache_len=torch.ones(1, dtype=torch.int32))


# ----------------------------------------------------------- paged insert

@pytest.mark.parametrize("window", [None, 8])
def test_paged_insert_matches_jax(window):
    """The same dense caches of a (4, 20) prefill (20 not a multiple of bs
    8; the last row padding of a 3-slot server) scattered by both packages:
    pools equal exactly outside the scratch block (where JAX writes the
    padding row and the port writes nothing), rings equal exactly."""
    jcfg, _, tcfg, _ = make_pair(window=window, seed=3)
    plen, bs, n_slots, n_blocks, max_len = 20, 8, 3, 13, 40
    cap = plen if window is None else min(window, plen)
    rng = np.random.default_rng(4)
    dense = {name: rng.standard_normal((tcfg.num_layers, 4, cap, tcfg.n_kv_heads,
                                        tcfg.head_dim)).astype(np.float32)
             for name in ("k", "v")}
    slots = np.array([2, 0, 1, n_slots], np.int32)
    table = np.array([[3, 7, 1], [12, 5, 9], [2, 11, 4], [0, 0, 0]], np.int32)
    jcaches = JPC.paged_cache_init(jcfg, n_slots, n_blocks, bs, max_len, jcfg.dtype)
    jcaches = JPC.paged_insert(jcfg, jcaches, [{"b0": {n: jnp.asarray(a) for n, a in
                                                        dense.items()}}],
                               jnp.asarray(slots), jnp.asarray(table), plen)
    tcaches = PC.paged_cache_init(tcfg, n_slots, n_blocks, bs, max_len, torch.float32, "cpu")
    tdense = [{n: torch.from_numpy(a[layer]) for n, a in dense.items()}
              for layer in range(tcfg.num_layers)]
    PC.paged_insert(tcfg, tcaches, tdense, slots, table, plen, n_slots=n_slots)
    for layer, tc in enumerate(tcaches):
        for name in ("k", "v"):
            want = np.asarray(jcaches[0]["b0"][name][layer])
            got = tc[name].numpy()
            if window is None:
                got, want = got[PC.RESERVED_BLOCKS:], want[PC.RESERVED_BLOCKS:]
            else:
                assert got.shape == (n_slots, window, tcfg.n_kv_heads, tcfg.head_dim)
            assert np.abs(got).sum() > 0
            np.testing.assert_array_equal(got, want)
    if window is None:  # nothing written to the scratch block
        assert not tcaches[0]["k"][0].any()


# ------------------------------------------------------ paged decode step

def test_paged_decode_and_sample_step_matches_jax(pair):
    """Three rows at ragged positions through a shuffled table, two greedy
    steps: tokens equal, logprobs within 1e-4."""
    jcfg, jparams, tcfg, tparams = pair
    bs, m, plen = 8, 4, 16
    rng = np.random.default_rng(5)
    toks = rng.integers(1, tcfg.vocab_size, (3, plen)).astype(np.int32)
    table = rng.permutation(np.arange(1, 1 + 3 * m)).reshape(3, m).astype(np.int32)
    slots = np.arange(3, dtype=np.int32)
    nb = PC.needed_blocks(plen, bs)
    _, jdense = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, plen)
    jc = JPC.paged_cache_init(jcfg, 3, 1 + 3 * m, bs, 32, jcfg.dtype)
    jc = JPC.paged_insert(jcfg, jc, jdense, jnp.asarray(slots), jnp.asarray(table[:, :nb]),
                          plen)
    _, tdense = TM.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks)}, plen,
                           impl="reference")
    tc = PC.paged_cache_init(tcfg, 3, 1 + 3 * m, bs, 32, torch.float32, "cpu")
    PC.paged_insert(tcfg, tc, tdense, slots, table[:, :nb], plen, n_slots=3)
    # rows sit at different positions, as if the later rows had generated
    # a few tokens already (those slots hold zeros on both sides)
    pos = np.array([16, 19, 23], np.int32)
    tok = rng.integers(1, tcfg.vocab_size, 3).astype(np.int32)
    jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok)
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    for _ in range(2):
        jtok, jlp, jc = JM.paged_decode_and_sample_step(
            jparams, jcfg, jtok, jc, jnp.asarray(table), jpos, None)
        ttok, tlp, tc = TM.paged_decode_and_sample_step(
            tparams, tcfg, ttok, tc, torch.from_numpy(table), tpos, impl="reference")
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=TOL)
        jpos, tpos = jpos + 1, tpos + 1


# ----------------------------------------------------------- the server

def _prompts(vocab, n, plen=16, seed=0):
    r = np.random.default_rng(seed)
    return [r.integers(1, vocab, plen).astype(np.int32) for _ in range(n)]


def _generate(tcfg, tparams, prompt, n):
    return TM.generate(tparams, tcfg, {"tokens": torch.from_numpy(prompt[None])},
                       num_new_tokens=n, impl="reference")["tokens"][0].numpy()


def _scenario(name, vocab, eos_of):
    """(server kwargs, prompts, per-request max_new) of a scenario of
    ``tests/test_paged.py``."""
    if name == "plain":
        return (dict(n_slots=2, kv_block_size=8, max_prompt=16, max_new=16),
                _prompts(vocab, 4), [3, 9, 5, 2])
    if name == "short_before_long":
        # pool: short (4+1) + long (4+5) usable blocks; the queued request
        # is admitted only out of blocks the short one released
        pool = 1 + (4 + 1) + (4 + 5)
        return (dict(n_slots=2, kv_block_size=4, max_kv_blocks=pool, max_prompt=16,
                     max_new=20), _prompts(vocab, 3), [2, 20, 2])
    if name == "preemption":
        pool = 1 + 2 * PC.needed_blocks(16, 4) + 2  # both prompts, not both generations
        return (dict(n_slots=2, kv_block_size=4, max_kv_blocks=pool, max_prompt=16,
                     max_new=12), _prompts(vocab, 2), [12, 12])
    if name == "eos":
        prompts = _prompts(vocab, 2)
        return (dict(n_slots=2, kv_block_size=8, max_prompt=16, max_new=10,
                     eos_id=eos_of(prompts[0])), prompts, [10, 10])
    if name == "oversize":  # the second request is rejected first, then
        # the server serves the first one alone
        return (dict(n_slots=2, kv_block_size=8, max_prompt=16, max_new=8),
                _prompts(vocab, 2), [4, 16 + 8 + 1])
    raise KeyError(name)


@pytest.mark.parametrize("name", ["plain", "short_before_long", "preemption", "eos",
                                  "oversize"])
def test_continuous_greedy_matches_jax_and_generate(pair, name):
    """Greedy serving on bucket-exact prompts: tokens bit-identical to the
    JAX ``ContinuousBatchServer`` and to the port's ``generate``, logprobs
    within 1e-4, and the same schedule (steps, preemptions, peak blocks,
    completion order)."""
    jcfg, jparams, tcfg, tparams = pair

    def eos_of(prompt):  # the request's second greedy token
        return int(_generate(tcfg, tparams, prompt, 2)[1])

    kw, prompts, new = _scenario(name, tcfg.vocab_size, eos_of)
    tsrv = tserve.ContinuousBatchServer(tcfg, tparams, impl="reference", **kw)
    jsrv = jserve.ContinuousBatchServer(jcfg, jparams, **kw)
    if name == "oversize":
        # rejected before any work starts, so a bad request cannot raise
        # mid-flight and lose the in-flight ones; the server stays usable
        for serve in (lambda: tsrv.serve(prompts, max_new=new),
                      lambda: jsrv.serve(prompts, rng=None, max_new=new)):
            with pytest.raises(ValueError, match="exceeds max_len"):
                serve()
        assert not tsrv.queue and not tsrv._active()
        prompts, new = prompts[:1], new[:1]
    ttoks, tlps = tsrv.serve(prompts, max_new=new)
    jtoks, jlps = jsrv.serve(prompts, rng=None, max_new=new)
    for t, j, tl, jl in zip(ttoks, jtoks, tlps, jlps):
        np.testing.assert_array_equal(t, np.asarray(j))
        np.testing.assert_allclose(tl, np.asarray(jl), atol=TOL)
    keys = ("steps", "preemptions", "peak_blocks", "completion_order")
    tst, jst = tsrv.stats(), jsrv.stats()
    assert {k: tst[k] for k in keys} == {k: jst[k] for k in keys}
    assert tst["latency_s"]["n"] == len(prompts)
    for pr, t, n in zip(prompts, ttoks, new):
        want = _generate(tcfg, tparams, pr, n)
        np.testing.assert_array_equal(t, want[:len(t)])
        assert len(t) == n or (name == "eos" and t[-1] == kw["eos_id"])
    if name == "short_before_long":
        assert tst["completion_order"][0] == 0 and tst["completion_order"][-1] == 1
        assert tst["peak_blocks"] <= kw["max_kv_blocks"] - 1
    if name == "preemption":
        assert tst["preemptions"] >= 1
    if name == "eos":
        assert ttoks[0][-1] == kw["eos_id"] and len(ttoks[0]) <= 2
    assert not tsrv.queue and not tsrv._active() and tsrv.alloc.used_count == 0


def test_continuous_window_layers_match_jax():
    """Window layers keep per-slot rings (``ragged_attn_decode_apply``);
    prompts of 16 overflow the window of 8."""
    jcfg, jparams, tcfg, tparams = make_pair(window=8, seed=4)
    prompts, new = _prompts(tcfg.vocab_size, 3, seed=1), [4, 8, 2]
    kw = dict(n_slots=2, kv_block_size=8, max_prompt=16, max_new=8)
    ttoks, tlps = tserve.ContinuousBatchServer(tcfg, tparams, impl="reference",
                                               **kw).serve(prompts, max_new=new)
    jtoks, jlps = jserve.ContinuousBatchServer(jcfg, jparams, **kw).serve(
        prompts, rng=None, max_new=new)
    for pr, t, j, tl, jl, n in zip(prompts, ttoks, jtoks, tlps, jlps, new):
        np.testing.assert_array_equal(t, np.asarray(j))
        np.testing.assert_allclose(tl, np.asarray(jl), atol=TOL)
        np.testing.assert_array_equal(t, _generate(tcfg, tparams, pr, n))


def test_continuous_sampled_logprobs_are_teacher_forced(pair):
    """Sampled serving (tempered, truncated, ragged prompts left-padded to
    their bucket): each returned logprob is the untempered logprob of that
    token under a teacher-forced ``forward``; top_k=1 equals greedy."""
    _, _, tcfg, tparams = pair
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, tcfg.vocab_size, n).astype(np.int32) for n in (5, 16, 20)]
    kw = dict(n_slots=2, kv_block_size=8, max_prompt=32, max_new=6, impl="reference")
    toks, lps = tserve.ContinuousBatchServer(tcfg, tparams, temperature=0.7, top_k=20,
                                             **kw).serve(prompts, seed=3)
    for pr, t, lp in zip(prompts, toks, lps):
        assert len(t) == 6
        pb = tserve.bucket_of(len(pr))
        seq = np.zeros(pb + len(t) - 1, np.int64)
        seq[pb - len(pr):pb] = pr
        seq[pb:] = t[:-1]
        h = TM.forward(tparams, tcfg, {"tokens": torch.from_numpy(seq[None])},
                       impl="reference")
        logp = torch.log_softmax(TM.logits_of(tparams, tcfg, h)[0, pb - 1:], dim=-1)
        want = logp.gather(-1, torch.from_numpy(t.astype(np.int64))[:, None])[:, 0]
        np.testing.assert_allclose(lp, want.numpy(), atol=TOL)
    greedy, _ = tserve.ContinuousBatchServer(tcfg, tparams, **kw).serve(prompts)
    top1, _ = tserve.ContinuousBatchServer(tcfg, tparams, top_k=1, **kw).serve(
        prompts, seed=3)
    for g, t1, s in zip(greedy, top1, toks):
        np.testing.assert_array_equal(t1, g)
    assert not all(np.array_equal(g, s) for g, s in zip(greedy, toks))


def test_build_server_modes_and_unported_options(pair):
    _, _, tcfg, tparams = pair
    exp = ExperimentConfig(serve_mode="continuous", kv_block_size=8)
    srv = tserve.build_server(tcfg, tparams, exp, max_prompt=16, max_new=4)
    assert isinstance(srv, tserve.ContinuousBatchServer)
    assert srv.bs == 8 and srv.impl == "reference"
    exp = ExperimentConfig(serve_mode="bucketed")
    assert isinstance(tserve.build_server(tcfg, tparams, exp), tserve.BatchServer)
    with pytest.raises(ValueError, match="serve_mode"):
        tserve.build_server(tcfg, tparams, ExperimentConfig(serve_mode="nope"))
    # speculative decoding is ported: a draft gives the spec engine
    srv = tserve.ContinuousBatchServer(tcfg, tparams, draft_params=tparams, draft_cfg=tcfg)
    assert srv.draft_cfg is tcfg and srv.spec_controller is None
    srv = tserve.build_server(tcfg, tparams, ExperimentConfig(draft_model=tcfg),
                              draft_params=tparams)
    assert srv.draft_cfg is tcfg and srv.spec_controller is not None
    with pytest.raises(NotImplementedError, match="cdf"):
        tserve.build_server(tcfg, tparams, ExperimentConfig(sampler="gumbel"))
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        tserve.ContinuousBatchServer(tcfg, tparams, max_prompt=16, max_new=2).serve(
            _prompts(tcfg.vocab_size, 1))
