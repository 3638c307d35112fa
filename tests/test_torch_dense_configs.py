"""The dense decoder configs qwen3-1.7b (qk-norm, tied), gemma3-1b (5:1
local:global windows, qk-norm, gelu, head_dim 256 > d_model / n_heads,
tied) and qwen2.5-14b (QKV bias, untied) in the port against the JAX
package: the configs and their counts, and at the reduced size in fp32 the
forward and prefill logits, prefill plus 8 teacher-forced decode steps,
the paged decode through a shuffled block table (gemma3: global layers on
the pools, local ones on per-slot rings), greedy ``generate``, and for
gemma3 the continuous and bucketed servers.

Weights come from the JAX package's ``init_params`` bridged through numpy,
the embedding scaled by 0.05, biases and norm scales (the qk-norm scales
too) randomised.  "gemma3-1b-qdim" is reduced gemma3 at head_dim 32, so
q_dim (128) differs from d_model (64) as at full width (1,024 against
1,152).  Reduced gemma3's window is 16; prompts of 20-40 tokens wrap its
rings.  Stated tolerances: logits within 1e-5 of the largest |logit|
(``LOGIT_RTOL``), logprobs within 1e-5 (1 + |logprob|); greedy tokens,
server outputs and schedules bit-equal.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.core import realloc as JR
from repro.launch import serve as jserve
from repro.models import model as JM
from repro.models import paged_cache as JPC
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import get_config
from repro_torch.core import realloc as TR
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.models import paged_cache as PC
from test_torch_model import _dicts

NAMES = ("qwen3-1.7b", "gemma3-1b", "qwen2.5-14b")
VARIANTS = {"qwen3-1.7b": ("qwen3-1.7b", {}), "gemma3-1b": ("gemma3-1b", {}),
            "gemma3-1b-qdim": ("gemma3-1b", {"head_dim": 32}),
            "qwen2.5-14b": ("qwen2.5-14b", {})}
LOGIT_RTOL = 1e-5
# the JAX package's steps, jitted once per config (as its generate loop
# does) so that each decode step does not retrace
JDECODE = jax.jit(JM.decode_step, static_argnums=(1,))
JPAGED = jax.jit(lambda p, cfg, tok, c, tbl, pos: JM.paged_decode_and_sample_step(
    p, cfg, tok, c, tbl, pos, None), static_argnums=(1,))


@functools.lru_cache(maxsize=None)
def make_pair(variant, seed=0):
    """(jax cfg, jax params, port cfg, port params) with shared weights."""
    arch, kw = VARIANTS[variant]
    jcfg, tcfg = JARCHS[arch].reduced(**kw), TARCHS[arch].reduced(**kw)
    tree = jax.tree.map(np.array, JM.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    tree["embed"]["table"] *= 0.05
    for d in _dicts(tree):
        if "b" in d:
            d["b"] = rng.normal(0, 0.1, d["b"].shape).astype(np.float32)
        if "scale" in d:
            d["scale"] = (1 + rng.normal(0, 0.1, d["scale"].shape)).astype(np.float32)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_jax(tree, tcfg, device="cpu")


@pytest.fixture(scope="module", params=list(VARIANTS))
def pair(request):
    return make_pair(request.param)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(1, vocab, shape).astype(np.int32)


def assert_logits_close(got, want, msg=""):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_RTOL * np.abs(want).max(), err_msg=msg)


def assert_logprobs_close(got, want):
    want = np.asarray(want, np.float64)
    assert np.all(np.abs(np.asarray(got) - want) <= 1e-5 * (1 + np.abs(want)))


# ------------------------------------------------------------- the configs

@pytest.mark.parametrize("reduced", [False, True])
@pytest.mark.parametrize("name", NAMES)
def test_configs_and_counts_equal_jax(name, reduced):
    jc, tc = JARCHS[name], get_config(name)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    jd, td = dataclasses.asdict(jc), dataclasses.asdict(tc)
    assert set(jd) == set(td)
    assert (tc.dense_residual_ffn, tc.moe_dispatch) == (jc.dense_residual_ffn, jc.moe_dispatch) \
        == (False, "dropless")
    assert jd == td
    assert [(s.kind, s.window, s.has_ffn) for s in tc.layers] == \
        [(s.kind, s.window, s.has_ffn) for s in jc.layers]
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert TR.layer_bytes(tc) == JR.layer_bytes(jc)
    assert (tc.q_dim, tc.kv_dim) == (jc.q_dim, jc.kv_dim)


def test_full_width_shapes():
    """What phase 12 runs: the published widths."""
    g = get_config("gemma3-1b")
    assert (g.q_dim, g.d_model, g.head_dim, g.n_heads // g.n_kv_heads) == (1024, 1152, 256, 4)
    assert [s.window for s in g.layers].count(None) == 4 and len(g.layers) == 26
    assert g.vocab_size == 262144 and g.tie_embeddings and g.act == "gelu" and g.qk_norm
    q = get_config("qwen2.5-14b")
    assert q.n_heads // q.n_kv_heads == 5 and q.qkv_bias and not q.tie_embeddings
    assert round(q.param_count() / 1e9, 1) == 14.8
    assert get_config("qwen3-1.7b").qk_norm and get_config("qwen3-1.7b").num_layers == 28


# --------------------------------------------------------------- the model

def test_forward_logits_match_jax(pair):
    jcfg, jp, tcfg, tp = pair
    toks = _tokens(1, (2, 40), jcfg.vocab_size)
    jh, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, remat=False)
    th = TM.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)}, impl="reference")
    assert_logits_close(TM.logits_of(tp, tcfg, th).numpy(), JM.logits_of(jp, jcfg, jh))


def test_teacher_forced_decode_matches_jax(pair):
    """Prefill of 20 tokens (past reduced gemma3's window of 16), then 8
    decode steps of fixed tokens: the prefill's last logits and every
    step's agree."""
    jcfg, jp, tcfg, tp = pair
    b, s, steps = 2, 20, 8
    toks, feed = _tokens(2, (b, s), jcfg.vocab_size), _tokens(3, (b, steps), jcfg.vocab_size)
    jlast, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, s + steps)
    tlast, tc = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, s + steps,
                           impl="reference")
    assert_logits_close(TM.logits_of(tp, tcfg, tlast[:, None]).numpy(),
                        JM.logits_of(jp, jcfg, jlast[:, None]), "prefill")
    for i in range(steps):
        jl, jc = JDECODE(jp, jcfg, jnp.asarray(feed[:, i]), jc, jnp.int32(s + i))
        tl, tc = TM.decode_step(tp, tcfg, torch.from_numpy(feed[:, i]), tc, s + i,
                                impl="reference")
        assert_logits_close(tl.numpy(), jl, f"step {i}")


def test_paged_decode_matches_jax(pair):
    """Three rows of a 20-token prefill admitted through ``paged_insert``
    into a shuffled table (gemma3: 2 global layers on the pools, 12 local
    ones on rings of 16, which the prompt already wraps), then 8 greedy
    steps at ragged positions: tokens equal, logprobs within 1e-5."""
    jcfg, jp, tcfg, tp = pair
    bs, m, plen = 8, 5, 20
    rng = np.random.default_rng(5)
    toks = rng.integers(1, tcfg.vocab_size, (3, plen)).astype(np.int32)
    table = rng.permutation(np.arange(1, 1 + 3 * m)).reshape(3, m).astype(np.int32)
    slots = np.arange(3, dtype=np.int32)
    nb = PC.needed_blocks(plen, bs)
    _, jdense = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, plen)
    jc = JPC.paged_cache_init(jcfg, 3, 1 + 3 * m, bs, 40, jcfg.dtype)
    jc = JPC.paged_insert(jcfg, jc, jdense, jnp.asarray(slots), jnp.asarray(table[:, :nb]),
                          plen)
    _, tdense = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, plen,
                           impl="reference")
    tc = PC.paged_cache_init(tcfg, 3, 1 + 3 * m, bs, 40, torch.float32, "cpu")
    PC.paged_insert(tcfg, tc, tdense, slots, table[:, :nb], plen, n_slots=3)
    windows = [s.window for s in tcfg.layers]
    for w, c in zip(windows, tc):
        assert c["k"].shape[0] == (3 if w else 1 + 3 * m)  # rings per slot, else the pool
    pos = np.array([20, 22, 25], np.int32)
    tok = rng.integers(1, tcfg.vocab_size, 3).astype(np.int32)
    jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok)
    jpos, tpos = jnp.asarray(pos), torch.from_numpy(pos)
    for _ in range(8):
        jtok, jlp, jc = JPAGED(jp, jcfg, jtok, jc, jnp.asarray(table), jpos)
        ttok, tlp, tc = TM.paged_decode_and_sample_step(tp, tcfg, ttok, tc,
                                                        torch.from_numpy(table), tpos,
                                                        impl="reference")
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        assert_logprobs_close(tlp.numpy(), jlp)
        jpos, tpos = jpos + 1, tpos + 1


@pytest.mark.parametrize("name", NAMES)
def test_greedy_generate_is_bit_identical(name):
    jcfg, jp, tcfg, tp = make_pair(name)
    toks = _tokens(4, (3, 24), jcfg.vocab_size)
    jout = JM.generate(jp, jcfg, {"tokens": jnp.asarray(toks)}, num_new_tokens=10)
    tout = TM.generate(tp, tcfg, {"tokens": torch.from_numpy(toks)}, num_new_tokens=10,
                       impl="reference")
    np.testing.assert_array_equal(tout["tokens"].numpy(), np.asarray(jout["tokens"]))
    assert_logprobs_close(tout["logprobs"].numpy(), jout["logprobs"])
    assert len(set(tout["tokens"].numpy().ravel().tolist())) > 3  # not degenerate


# ------------------------------------------------------------- gemma3's windows

def test_window_attention_ignores_distant_tokens():
    """The JAX package's ``test_window_attention_ignores_distant_tokens``
    on the port: with only local layers (window 4, 2 layers) a token more
    than 2 windows back cannot reach the last position; with reduced
    gemma3's global layers it does."""
    base = TARCHS["gemma3-1b"].reduced()
    local = dataclasses.replace(base, superblock=(dataclasses.replace(base.superblock[0],
                                                                      window=4),),
                                n_superblocks=2, tail=(), num_layers=2)
    toks = torch.from_numpy(_tokens(6, (1, 32), base.vocab_size))
    toks2 = toks.clone()
    toks2[:, 0] = (toks2[:, 0] + 1) % base.vocab_size
    for cfg, reaches in ((local, False), (base, True)):
        p = TM.init_params(cfg, seed=0, device="cpu")
        h1, h2 = (TM.forward(p, cfg, {"tokens": t}, impl="reference")[:, -1] for t in (toks, toks2))
        assert bool((h1 - h2).abs().max() > 1e-4) == reaches, cfg.name


# ------------------------------------------------------------- the servers

@pytest.fixture(scope="module")
def gemma():
    return make_pair("gemma3-1b", seed=7)


def _prompts(vocab, lens, seed):
    r = np.random.default_rng(seed)
    return [r.integers(1, vocab, n).astype(np.int32) for n in lens]


def test_continuous_server_matches_jax_on_gemma3(gemma):
    """Three prompts of 17-32 tokens (past the window of 16, ragged,
    left-padded to bucket 32) on 2 slots, blocks of 8 and rings of 16 per
    slot, the pool too small for two full generations: the third request
    queues, a row is preempted and re-admitted (its ring and blocks reset).
    Tokens, schedule and completion order bit-equal to the JAX server's,
    logprobs within 1e-5."""
    jcfg, jp, tcfg, tp = gemma
    pool = 1 + 2 * PC.needed_blocks(32, 8) + 2
    kw = dict(n_slots=2, kv_block_size=8, max_kv_blocks=pool, max_prompt=32, max_new=24)
    prompts, new = _prompts(tcfg.vocab_size, (29, 32, 17), 2), [24, 24, 6]
    tsrv = tserve.ContinuousBatchServer(tcfg, tp, impl="reference", **kw)
    jsrv = jserve.ContinuousBatchServer(jcfg, jp, **kw)
    ttoks, tlps = tsrv.serve(prompts, max_new=new)
    jtoks, jlps = jsrv.serve(prompts, rng=None, max_new=new)
    for t, j, tl, jl, n in zip(ttoks, jtoks, tlps, jlps, new):
        assert len(t) == n
        np.testing.assert_array_equal(t, np.asarray(j))
        assert_logprobs_close(tl, jl)
    keys = ("steps", "preemptions", "peak_blocks", "completion_order")
    tst, jst = tsrv.stats(), jsrv.stats()
    assert {k: tst[k] for k in keys} == {k: jst[k] for k in keys}
    assert tst["preemptions"] >= 1
    assert not tsrv.queue and not tsrv._active() and tsrv.alloc.used_count == 0


def test_bucketed_server_matches_jax_on_gemma3(gemma):
    jcfg, jp, tcfg, tp = gemma
    prompts = _prompts(tcfg.vocab_size, (30, 17, 24), 3)  # bucket 32, past the window
    outs = tserve.BatchServer(tcfg, tp, max_new=8, impl="reference").serve(prompts)
    jouts = jserve.BatchServer(jcfg, jp, max_new=8).serve(prompts, None)
    for out, jout in zip(outs, jouts):
        np.testing.assert_array_equal(out.numpy(), np.asarray(jout))
