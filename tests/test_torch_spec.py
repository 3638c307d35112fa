"""The port's speculative decoding against the JAX package: the support
predicate, the adaptive draft-length controller, batched rejection sampling
(``ops.spec_verify``), the paged verify attention (both tiers; on the CPU
the kernel tier's wrapper runs its plain version), the two verify layers,
``paged_verify_step``, and ``spec_generate`` / ``paged_generate`` on reduced
qwen2-0.5b (also with window layers) and granite-moe-1b-a400m.

Weights are the JAX package's ``init_params`` bridged into the port (the
embedding scaled by 0.05 and norm scales randomised, as in
``test_torch_model.make_pair``); the draft is the target with every weight
perturbed by N(0, 0.02) noise, so that it disagrees often (accept rate
under 0.5) but not always, and both the accept and the reject paths run.
Inputs are made with numpy from a seed.  Tolerances: attention 1e-5 (fp32),
logits and logprobs 2e-4 (fp32 through the model, as ``tests/test_spec.py``),
``spec_verify``'s logprobs 1e-5; tokens, accept lengths, schedules and
``k`` sequences are held exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as JA
from repro.models import model as JM
from repro.models import paged_cache as JPC
from repro.models import spec as JS
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as TA
from repro_torch.models import layers as L
from repro_torch.models import model as TM
from repro_torch.models import paged_cache as PC
from repro_torch.models import spec as TS
from test_torch_model import make_pair

ATTN_TOL = 1e-5
VERIFY_LP_TOL = 1e-5
TOL = 2e-4
DRAFT_NOISE = 0.02


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def noisy_draft(jparams, tcfg, seed=7, scale=DRAFT_NOISE):
    """(JAX params, port params) of the target with every floating leaf
    perturbed by N(0, scale) noise drawn in numpy."""
    rng = np.random.default_rng(seed)
    tree = jax.tree.map(lambda a: np.array(a) + rng.normal(0, scale, np.shape(a)).astype(
        np.asarray(a).dtype), jparams)
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree, tcfg, device="cpu")


@pytest.fixture(scope="module")
def pair():
    return make_pair(seed=2)


# ------------------------------------------------------ support, controller

@pytest.mark.parametrize("arch", ["qwen2-0.5b", "granite-moe-1b-a400m", "mamba2-1.3b",
                                  "recurrentgemma-9b"])
def test_spec_supported_matches_jax(arch):
    jcfg, tcfg = JARCHS[arch].reduced(), TARCHS[arch].reduced()
    assert TS.spec_supported(tcfg) == JS.spec_supported(jcfg)
    assert TS.spec_supported(tcfg) == (arch in ("qwen2-0.5b", "granite-moe-1b-a400m"))


def test_check_spec_pair_matches_jax():
    q_j, q_t = JARCHS["qwen2-0.5b"].reduced(), TARCHS["qwen2-0.5b"].reduced()
    m_j, m_t = JARCHS["mamba2-1.3b"].reduced(), TARCHS["mamba2-1.3b"].reduced()
    TS.check_spec_pair(q_t, q_t)
    JS.check_spec_pair(q_j, q_j)
    for (jt, jd), (tt, td) in [((q_j, dataclasses.replace(q_j, vocab_size=77)),
                                (q_t, dataclasses.replace(q_t, vocab_size=77))),
                               ((q_j, m_j), (q_t, m_t)), ((m_j, q_j), (m_t, q_t))]:
        with pytest.raises(ValueError) as want:
            JS.check_spec_pair(jt, jd)
        with pytest.raises(ValueError) as got:
            TS.check_spec_pair(tt, td)
        assert str(got.value) == str(want.value)


def test_spec_controller_k_sequence_matches_jax():
    """The same accept-rate sequence gives the same k sequence, EMA and
    picks, with the default cycle cost and with a custom one."""
    rates = np.random.default_rng(0).uniform(0, 1, 60)
    rates[:20] = 0.97
    rates[20:35] = 0.05

    def cost(k):
        return 0.02 * (k + 1) + 0.3 + 0.01 * k ** 1.5
    for kw in ({}, {"cycle_cost": cost, "k_max": 6, "init_k": 2, "decay": 0.8}):
        j, t = JS.SpecController(**kw), TS.SpecController(**kw)
        for r in rates:
            assert t.update(float(r)) == j.update(float(r))
        assert t.history == j.history
    for a, k in ((0.0, 5), (0.5, 3), (0.999999, 5), (1.3, 2)):
        assert TS.SpecController.expected_committed(a, k) == \
            JS.SpecController.expected_committed(a, k)
    with pytest.raises(ValueError):
        TS.SpecController(k_min=3, init_k=2)


# -------------------------------------------------------------- spec_verify

def _verify_inputs(seed, b, k, v, agree=0.5, spread=1.5):
    """Target and draft logits, and draft tokens that equal the target's
    argmax with probability ``agree`` per position."""
    rng = np.random.default_rng(seed)
    lg = (rng.standard_normal((b, k + 1, v)) * spread).astype(np.float32)
    dlg = (lg[:, :k] + rng.standard_normal((b, k, v)) * spread).astype(np.float32)
    dt = np.where(rng.uniform(size=(b, k)) < agree, lg[:, :k].argmax(-1),
                  rng.integers(0, v, (b, k))).astype(np.int32)
    return lg, dt, dlg


def _check_verify(got, want):
    acc, tok, tok_lp, dlps = (x.numpy() for x in got)
    np.testing.assert_array_equal(acc, np.asarray(want[0]))
    np.testing.assert_array_equal(tok, np.asarray(want[1]))
    np.testing.assert_allclose(tok_lp, np.asarray(want[2]), atol=VERIFY_LP_TOL)
    np.testing.assert_allclose(dlps, np.asarray(want[3]), atol=VERIFY_LP_TOL)
    return acc


@pytest.mark.parametrize("b,k,v", [(16, 3, 37), (8, 1, 2048), (8, 6, 151)])
def test_spec_verify_greedy_matches_jax(b, k, v):
    lg, dt, dlg = _verify_inputs(b + k + v, b, k, v, agree=0.7)
    want = jops.spec_verify(jnp.asarray(lg), jnp.asarray(dt), jnp.asarray(dlg), None)
    acc = _check_verify(ops.spec_verify(_t(lg), _t(dt), _t(dlg), impl="reference"), want)
    assert 0 < acc.max() and acc.min() < k  # partial and full sweeps both ran


@pytest.mark.parametrize("temperature,top_k,top_p", [(1.0, 0, 1.0), (0.8, 16, 1.0),
                                                     (1.3, 0, 0.9), (0.7, 5, 0.8)])
@pytest.mark.parametrize("v", [40, 2048])
def test_spec_verify_sampled_with_jax_uniforms(temperature, top_k, top_p, v):
    """With the JAX package's own uniforms injected (``ku, kr =
    split(key)``; u (B, K) from ku, the residual draw's (B, 1) from kr),
    accept lengths and tokens equal the JAX ones."""
    b, k = 32, 4
    lg, dt, dlg = _verify_inputs(v + top_k, b, k, v, agree=0.5, spread=1.0)
    # draft tokens drawn from the draft distribution itself, so most are accepted
    dt[: b // 2] = np.asarray(jax.random.categorical(
        jax.random.PRNGKey(1), jnp.asarray(dlg[: b // 2]) / temperature, axis=-1))
    accs = []
    for seed in range(3):
        key = jax.random.PRNGKey(seed)
        ku, kr = jax.random.split(key)
        u = (np.asarray(jax.random.uniform(ku, (b, k))), np.asarray(jax.random.uniform(kr, (b, 1))))
        want = jops.spec_verify(jnp.asarray(lg), jnp.asarray(dt), jnp.asarray(dlg), key,
                                temperature=temperature, top_k=top_k, top_p=top_p)
        got = ops.spec_verify(_t(lg), _t(dt), _t(dlg), temperature=temperature, top_k=top_k,
                              top_p=top_p, impl="reference", uniforms=tuple(map(_t, u)))
        accs.append(_check_verify(got, want))
    accs = np.concatenate(accs)
    assert accs.min() < k and accs.max() > 0


def test_spec_verify_rejection_sampling_distribution():
    """Seeded statistical check of the rejection-sampling invariant (as
    ``tests/test_spec.py``): over 4000 verify trials with a disagreeing
    draft, the first emitted token's marginal is the target's distribution
    (atol 0.04), with a torch.Generator's draws."""
    n, k, v = 4000, 2, 8
    g = torch.Generator().manual_seed(5)
    p_log = torch.randn((1, k + 1, v), generator=g) * 1.5
    q_log = torch.randn((1, k, v), generator=g) * 1.5
    draft0 = torch.multinomial(torch.softmax(q_log[0, 0], -1), n, replacement=True,
                               generator=g)
    draft = torch.stack([draft0, torch.zeros(n, dtype=torch.long)], dim=1).to(torch.int32)
    acc, tok, _, _ = ops.spec_verify(p_log.expand(n, -1, -1), draft, q_log.expand(n, -1, -1),
                                     torch.Generator().manual_seed(11), impl="reference")
    first = torch.where(acc >= 1, draft0.to(torch.int32), tok).numpy()
    emp = np.bincount(first, minlength=v) / n
    assert acc.min() == 0 and acc.max() >= 1  # both branches ran
    np.testing.assert_allclose(emp, torch.softmax(p_log[0, 0], -1).numpy(), atol=0.04)


def test_spec_verify_refuses_bad_shapes_and_cuda_on_cpu():
    lg, dt, dlg = _verify_inputs(0, 2, 3, 11)
    with pytest.raises(ValueError, match="shape mismatch"):
        ops.spec_verify(_t(lg), _t(dt[:, :2]), _t(dlg), impl="reference")
    with pytest.raises(ValueError, match="truncation"):
        ops.spec_verify(_t(lg), _t(dt), _t(dlg), top_p=0.0, impl="reference")
    with pytest.raises(ValueError, match="impl"):
        ops.spec_verify(_t(lg), _t(dt), _t(dlg), impl="pallas")


# ------------------------------------------------------- verify attention

def _pool_inputs(seed, b, kk, hq, hkv, d, bs, m, starts):
    rng = np.random.default_rng(seed)
    n = 1 + b * m
    q = rng.standard_normal((b, kk, hq, d)).astype(np.float32)
    k_pool = rng.standard_normal((n, bs, hkv, d)).astype(np.float32)
    v_pool = rng.standard_normal((n, bs, hkv, d)).astype(np.float32)
    tbl = rng.permutation(np.arange(1, n)).reshape(b, m).astype(np.int32)
    qpos = (np.asarray(starts)[:, None] + np.arange(kk)[None]).astype(np.int32)
    return q, k_pool, v_pool, tbl, qpos


@pytest.mark.parametrize("b,kk,hq,hkv,d,bs,m,starts", [
    (3, 4, 8, 2, 16, 8, 5, (0, 17, 35)),
    (2, 9, 14, 2, 64, 16, 4, (40, 3)),     # qwen2-0.5b heads, Sq = k + 1 = 9
    (2, 2, 4, 1, 32, 6, 7, (13, 39)),      # bs not dividing the kernel's 64-key tile
])
def test_paged_verify_mha_matches_jax_and_single_token_decodes(monkeypatch, b, kk, hq, hkv, d,
                                                                bs, m, starts):
    """Both tiers (the kernel tier's gather and wrapper, whose CPU path is
    the plain version) against ``ref.paged_verify_mha_ref`` (fp32 1e-5),
    and query j against a single-token paged decode at position
    q_positions[:, j] on the same pool."""
    q, k_pool, v_pool, tbl, qpos = _pool_inputs(sum(starts), b, kk, hq, hkv, d, bs, m, starts)
    want = np.asarray(jref.paged_verify_mha_ref(*map(jnp.asarray, (q, k_pool, v_pool, tbl)),
                                                q_positions=jnp.asarray(qpos)))
    args = [_t(a) for a in (q, k_pool, v_pool, tbl)]
    got_ref = ops.paged_verify_mha(*args, q_positions=_t(qpos), impl="reference").numpy()
    monkeypatch.setattr(ops, "_check", lambda impl, *tensors: None)  # the CUDA branch on CPU
    got_kernel = ops.paged_verify_mha(*args, q_positions=_t(qpos), impl="cuda").numpy()
    np.testing.assert_allclose(got_ref, want, atol=ATTN_TOL)
    np.testing.assert_allclose(got_kernel, want, atol=ATTN_TOL)
    for j in range(kk):
        one = ref.paged_decode_mha_ref(args[0][:, j], *args[1:],
                                       cache_len=_t(qpos[:, j] + 1)).numpy()
        np.testing.assert_allclose(got_ref[:, j], one, atol=ATTN_TOL)


def _layer_p(jparams, tparams, layer=0):
    jp = jax.tree.map(lambda a: a[layer], jparams["groups"][0]["b0"]["mixer"])
    return jp, tparams["layers"][layer]["mixer"]


def test_paged_verify_layer_matches_jax(pair):
    """``paged_attn_verify_apply`` against the JAX layer on the same pool:
    outputs within 2e-4 (fp32 through the projections), pools equal to
    1e-5 outside the scratch block 0."""
    jcfg, jparams, tcfg, tparams = pair
    jp, tp = _layer_p(jparams, tparams)
    b, kk, bs, m = 3, 4, 8, 5
    _, k_pool, v_pool, tbl, qpos = _pool_inputs(1, b, kk, 1, tcfg.n_kv_heads, tcfg.head_dim,
                                                bs, m, (0, 9, 31))
    x = np.random.default_rng(2).standard_normal((b, kk, tcfg.d_model)).astype(np.float32)
    y_j, cache_j = JA.paged_attn_verify_apply(
        jp, jcfg, jcfg.layers[0], jnp.asarray(x), {"k": jnp.asarray(k_pool),
                                                   "v": jnp.asarray(v_pool)},
        jnp.asarray(tbl), jnp.asarray(qpos), impl="reference")
    cache_t = {"k": _t(k_pool.copy()), "v": _t(v_pool.copy())}
    pos = _t(qpos)
    dest = (_t(tbl)[torch.arange(b)[:, None], pos.long() // bs].long(), pos.long() % bs)
    rope = L.rope_tables(pos, tcfg.head_dim, tcfg.rope_theta)
    y_t = TA.paged_attn_verify_apply(tp, tcfg, _t(x), cache_t, _t(tbl), dest, rope, pos,
                                     impl="reference")
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache_t[name].numpy()[1:], np.asarray(cache_j[name])[1:],
                                   atol=ATTN_TOL)


@pytest.mark.parametrize("starts", [(0, 5, 30), (2, 16, 47)])
def test_ragged_verify_layer_matches_jax(starts):
    """``ragged_attn_verify_apply`` (window 8, ring of 8, K = 4) against the
    JAX layer: rows whose window starts before any write, inside the ring
    and after it has wrapped; outputs 2e-4.  The port writes the ring at
    ``commit_ring``: with every token kept its ring equals the JAX layer's
    (1e-5); with keep = (0, 2, 4) only those tokens' slots change."""
    jcfg, jparams, tcfg, tparams = make_pair(window=8, seed=3)
    jp, tp = _layer_p(jparams, tparams)
    b, kk, cap = 3, 4, 8
    rng = np.random.default_rng(sum(starts))
    ring = rng.standard_normal((2, b, cap, tcfg.n_kv_heads, tcfg.head_dim)).astype(np.float32)
    qpos = (np.asarray(starts)[:, None] + np.arange(kk)[None]).astype(np.int32)
    x = rng.standard_normal((b, kk, tcfg.d_model)).astype(np.float32)
    y_j, cache_j = JA.ragged_attn_verify_apply(
        jp, jcfg, jcfg.layers[0], jnp.asarray(x), {"k": jnp.asarray(ring[0]),
                                                   "v": jnp.asarray(ring[1])},
        jnp.asarray(qpos), impl="reference")
    cache_t = {"k": _t(ring[0].copy()), "v": _t(ring[1].copy())}
    rope = L.rope_tables(_t(qpos), tcfg.head_dim, tcfg.rope_theta)
    y_t = TA.ragged_attn_verify_apply(tp, tcfg, tcfg.layers[0], _t(x), cache_t, rope,
                                      _t(qpos), impl="reference")
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=TOL)
    pending = cache_t["verify"]
    TA.commit_ring(cache_t, torch.full((b,), kk))
    for name in ("k", "v"):
        np.testing.assert_allclose(cache_t[name].numpy(), np.asarray(cache_j[name]),
                                   atol=ATTN_TOL)
    part = {"k": _t(ring[0].copy()), "v": _t(ring[1].copy()), "verify": pending}
    keep = np.array([0, 2, 4])
    TA.commit_ring(part, _t(keep))
    slots = qpos % cap
    for row in range(b):
        written = set(slots[row, :keep[row]].tolist())
        for s in range(cap):
            want = np.asarray(cache_j["k"])[row, s] if s in written else ring[0][row, s]
            np.testing.assert_allclose(part["k"][row, s].numpy(), want, atol=ATTN_TOL)
    assert "verify" not in part
    with pytest.raises(ValueError, match="ring"):
        TA.ragged_attn_verify_apply(tp, tcfg, dataclasses.replace(tcfg.layers[0], window=None),
                                    _t(x), cache_t, rope, _t(qpos), impl="reference")


def test_paged_verify_step_matches_jax(pair):
    """Admission then one verify step on both packages: the (B, K, V)
    logits within 2e-4 and every layer's pool within 1e-5 outside block 0;
    a recurrent config refuses the verify."""
    jcfg, jparams, tcfg, tparams = pair
    b, p, kk, bs = 3, 11, 5, 8
    toks = np.random.default_rng(4).integers(1, tcfg.vocab_size, (b, p)).astype(np.int32)
    window = np.random.default_rng(5).integers(1, tcfg.vocab_size, (b, kk)).astype(np.int32)
    m = PC.needed_blocks(p + kk, bs)
    tbl = (1 + np.arange(b * m)).reshape(b, m).astype(np.int32)
    nb0 = PC.needed_blocks(p, bs)
    qpos = (p + np.arange(kk)[None] + np.zeros((b, 1))).astype(np.int32)
    jc = JPC.paged_cache_init(jcfg, b, 1 + b * m, bs, p + kk, jcfg.dtype)
    _, _, jc = JS._admit_run(jcfg, p, False, 1.0, "cdf", 0, 1.0, "reference")(
        jparams, {"tokens": jnp.asarray(toks)}, jc, jnp.asarray(tbl[:, :nb0]),
        jax.random.PRNGKey(0))
    want, jc = JM.paged_verify_step(jparams, jcfg, jnp.asarray(window), jc, jnp.asarray(tbl),
                                    jnp.asarray(qpos), impl="reference")
    tc = PC.paged_cache_init(tcfg, b, 1 + b * m, bs, p + kk, torch.float32, "cpu")
    TS._admit_run(tparams, tcfg, _t(toks).long(), tc, np.arange(b), tbl[:, :nb0], p,
                  n_slots=b, impl="reference")
    got, _ = TM.paged_verify_step(tparams, tcfg, _t(window).long(), tc, _t(tbl), _t(qpos),
                                  impl="reference")
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, kk, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    for layer in range(tcfg.num_layers):
        for name in ("k", "v"):
            np.testing.assert_allclose(tc[layer][name].numpy()[1:],
                                       np.asarray(jc[0]["b0"][name][layer])[1:], atol=ATTN_TOL)
    rcfg = TARCHS["mamba2-1.3b"].reduced()
    rparams = TM.init_params(rcfg, seed=0, device="cpu")
    rc = PC.paged_cache_init(rcfg, 1, 4, bs, 16, torch.float32, "cpu")
    with pytest.raises(ValueError, match="attention-only"):
        TM.paged_verify_step(rparams, rcfg, torch.ones((1, 2), dtype=torch.long), rc,
                             torch.ones((1, 2), dtype=torch.int32),
                             torch.tensor([[3, 4]], dtype=torch.int32), impl="reference")


# ---------------------------------------------------------------- rollout

def _moe_pair():
    from test_torch_moe import make_pair as moe_pair
    return moe_pair(seed=5)


PAIRS = {"qwen2-0.5b": lambda: make_pair(seed=2),
         "qwen2-0.5b-window": lambda: make_pair(window=8, seed=2),
         "granite-moe-1b-a400m": _moe_pair}


@pytest.mark.parametrize("name", list(PAIRS))
def test_spec_generate_greedy_matches_jax_and_generate(name):
    """Greedy ``spec_generate`` with a noisy draft and the adaptive
    controller: tokens bit-identical to JAX ``spec_generate`` and to the
    port's own ``generate``; logprobs within 2e-4 of both; the same cycles,
    accepts and k trace as JAX; accept rate under 0.5.

    With window layers (window 8 over 17 positions, so the rings wrap) the
    JAX ``spec_generate`` parts from the JAX ``generate``: its verify
    writes rejected tokens into the ring over positions still attended.
    There the port is held to the JAX ``generate`` instead."""
    jcfg, jparams, tcfg, tparams = PAIRS[name]()
    jd, td = noisy_draft(jparams, tcfg)
    toks = np.random.default_rng(1).integers(1, tcfg.vocab_size, (3, 7)).astype(np.int32)
    new = 10
    got = TS.spec_generate(tparams, tcfg, td, tcfg, {"tokens": _t(toks).long()},
                           num_new_tokens=new, block_size=8, impl="reference",
                           controller=TS.SpecController(init_k=3))
    plain = TM.generate(tparams, tcfg, {"tokens": _t(toks).long()}, num_new_tokens=new,
                        impl="reference")
    if name.endswith("window"):
        want = JM.generate(jparams, jcfg, {"tokens": jnp.asarray(toks)}, num_new_tokens=new)
    else:
        want = JS.spec_generate(jparams, jcfg, jd, jcfg, {"tokens": jnp.asarray(toks)},
                                num_new_tokens=new, block_size=8,
                                controller=JS.SpecController(init_k=3))
        assert got["stats"] == want["stats"]
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["tokens"].numpy(), plain["tokens"].numpy())
    np.testing.assert_allclose(got["logprobs"].numpy(), np.asarray(want["logprobs"]), atol=TOL)
    np.testing.assert_allclose(got["logprobs"].numpy(), plain["logprobs"].numpy(), atol=TOL)
    assert 0.0 < got["stats"]["accept_rate"] < 0.5


def test_spec_generate_fixed_k_matches_jax(pair):
    """A fixed ``spec_k`` (no controller) and a second block size."""
    jcfg, jparams, tcfg, tparams = pair
    jd, td = noisy_draft(jparams, tcfg, seed=9)
    toks = np.random.default_rng(3).integers(1, tcfg.vocab_size, (2, 5)).astype(np.int32)
    want = JS.spec_generate(jparams, jcfg, jd, jcfg, {"tokens": jnp.asarray(toks)},
                            num_new_tokens=9, spec_k=2, block_size=4)
    got = TS.spec_generate(tparams, tcfg, td, tcfg, {"tokens": _t(toks).long()},
                           num_new_tokens=9, spec_k=2, block_size=4, impl="reference")
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_allclose(got["logprobs"].numpy(), np.asarray(want["logprobs"]), atol=TOL)
    assert got["stats"] == want["stats"]
    with pytest.raises(ValueError, match="spec_k"):
        TS.spec_generate(tparams, tcfg, td, tcfg, {"tokens": _t(toks).long()},
                         num_new_tokens=4, spec_k=0, impl="reference")
    rcfg = TARCHS["mamba2-1.3b"].reduced()
    with pytest.raises(ValueError, match="attention-only"):
        TS.spec_generate(tparams, tcfg, td, rcfg, {"tokens": _t(toks).long()},
                         num_new_tokens=4, impl="reference")


def teacher_forced_logprobs(params, cfg, prompts, toks, impl="reference"):
    """log-softmax of a teacher-forced ``forward`` over prompt + tokens, at
    each generated token."""
    full = torch.cat([prompts, toks.to(prompts.dtype)], dim=1)
    with torch.no_grad():
        h = TM.forward(params, cfg, {"tokens": full}, impl=impl)
        lps = torch.log_softmax(TM.logits_of(params, cfg, h).float(), dim=-1)
    p = prompts.shape[1]
    return lps[:, p - 1:-1].gather(-1, toks.long()[..., None])[..., 0]


def test_spec_generate_sampled_logprobs_match_teacher_forced(pair):
    """Sampled spec rollout (temperature 0.8, top-k 16): the returned
    logprobs are the untempered target's, a teacher-forced forward's within
    2e-4, whatever was accepted; the draws differ from greedy."""
    jcfg, jparams, tcfg, tparams = pair
    _, td = noisy_draft(jparams, tcfg)
    prompts = _t(np.random.default_rng(1).integers(1, tcfg.vocab_size, (4, 6))).long()
    out = TS.spec_generate(tparams, tcfg, td, tcfg, {"tokens": prompts}, num_new_tokens=10,
                           spec_k=3, rng=torch.Generator().manual_seed(9), temperature=0.8,
                           top_k=16, impl="reference")
    want = teacher_forced_logprobs(tparams, tcfg, prompts, out["tokens"])
    np.testing.assert_allclose(out["logprobs"].numpy(), want.numpy(), atol=TOL)
    greedy = TM.generate(tparams, tcfg, {"tokens": prompts}, num_new_tokens=10,
                         impl="reference")
    assert not torch.equal(out["tokens"], greedy["tokens"])
    assert out["stats"]["accepted"] > 0


@pytest.mark.parametrize("step_chunk", [1, 3])
def test_paged_generate_matches_generate_and_jax(pair, step_chunk):
    jcfg, jparams, tcfg, tparams = pair
    toks = np.random.default_rng(6).integers(1, tcfg.vocab_size, (3, 9)).astype(np.int32)
    want = JS.paged_generate(jparams, jcfg, {"tokens": jnp.asarray(toks)}, num_new_tokens=8,
                             block_size=4, step_chunk=step_chunk)
    got = TS.paged_generate(tparams, tcfg, {"tokens": _t(toks).long()}, num_new_tokens=8,
                            block_size=4, step_chunk=step_chunk, impl="reference")
    plain = TM.generate(tparams, tcfg, {"tokens": _t(toks).long()}, num_new_tokens=8,
                        impl="reference")
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["tokens"].numpy(), plain["tokens"].numpy())
    np.testing.assert_allclose(got["logprobs"].numpy(), np.asarray(want["logprobs"]), atol=TOL)
    assert got["peak_blocks"] == want["peak_blocks"]
