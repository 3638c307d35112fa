"""The port's dense model against the JAX package on the same weights.

Weights come from the JAX package's ``init_params`` on the reduced
qwen2-0.5b config (f32, 2 layers), go through numpy, and are bridged into
the port.  Before either side sees them the embedding table is scaled by
0.05 and biases and norm scales are randomised: with the raw init the tied
unembedding gives an almost one-hot next-token distribution, under which
sampled and greedy decoding coincide and a sampler test proves nothing.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs.base import ATTN as JATTN, LayerSpec as JLayerSpec
from repro.kernels import ops as jops
from repro.models import model as JM
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs.base import LayerSpec as TLayerSpec
from repro_torch.kernels import ops as tops
from repro_torch.models import model as TM

TOL = 1e-4


def make_pair(window=None, seed=0):
    """(jax cfg, jax params, port cfg, port params) with shared weights."""
    jcfg = JARCHS["qwen2-0.5b"].reduced()
    tcfg = TARCHS["qwen2-0.5b"].reduced()
    if window is not None:
        jcfg = dataclasses.replace(jcfg, superblock=(JLayerSpec(JATTN, window),))
        tcfg = dataclasses.replace(tcfg, superblock=(TLayerSpec("attn", window),))
    tree = jax.tree.map(np.array, JM.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    tree["embed"]["table"] *= 0.05
    for leaf_parent in _dicts(tree):
        if "b" in leaf_parent:
            leaf_parent["b"] = rng.normal(0, 0.1, leaf_parent["b"].shape).astype(np.float32)
        if "scale" in leaf_parent:
            s = leaf_parent["scale"]
            leaf_parent["scale"] = (1 + rng.normal(0, 0.1, s.shape)).astype(np.float32)
    jparams = jax.tree.map(jnp.asarray, tree)
    return jcfg, jparams, tcfg, params_from_jax(tree, tcfg, device="cpu")


def _dicts(tree):
    if isinstance(tree, dict):
        yield tree
        for v in tree.values():
            yield from _dicts(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _dicts(v)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(1, vocab, (b, s)).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    return make_pair()


def test_bridge_layout(pair):
    jcfg, jparams, tcfg, tparams = pair
    assert len(tparams["layers"]) == tcfg.num_layers == 2
    wq_j = np.asarray(jparams["groups"][0]["b0"]["mixer"]["wq"]["w"][1])
    np.testing.assert_array_equal(tparams["layers"][1]["mixer"]["wq"]["w"].numpy(), wq_j)
    assert "lm_head" not in tparams  # tied embeddings


def test_bridge_bf16_is_exact():
    jcfg = JARCHS["qwen2-0.5b"].reduced(dtype="bfloat16")
    tcfg = TARCHS["qwen2-0.5b"].reduced(dtype="bfloat16")
    tree = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(3), jcfg))
    tp = params_from_jax(tree, tcfg, device="cpu")
    t = tp["layers"][0]["ffn"]["w_out"]["w"]
    assert t.dtype == torch.bfloat16
    want = np.asarray(tree["groups"][0]["b0"]["ffn"]["w_out"]["w"][0], np.float32)
    np.testing.assert_array_equal(t.float().numpy(), want)


def test_forward_and_prefill_logits_match(pair):
    jcfg, jparams, tcfg, tparams = pair
    toks = _tokens(1, 2, 24, jcfg.vocab_size)
    jh, _ = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)}, remat=False)
    th = TM.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                    impl="reference")
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(TM.logits_of(tparams, tcfg, th).numpy(),
                               np.asarray(JM.logits_of(jparams, jcfg, jh)),
                               atol=TOL, rtol=TOL)

    jlast, _ = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, 40)
    tlast, _ = TM.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks)}, 40,
                          impl="reference")
    np.testing.assert_allclose(
        TM.logits_of(tparams, tcfg, tlast[:, None]).numpy(),
        np.asarray(JM.logits_of(jparams, jcfg, jlast[:, None])), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("window", [None, 8])
def test_teacher_forced_decode_logits_match(window):
    """Prefill, then decode a fixed token sequence; logits agree at every
    step.  With window 8 the prompt (12) already overflows the ring."""
    jcfg, jparams, tcfg, tparams = make_pair(window=window)
    b, s, steps = 2, 12, 6
    toks = _tokens(2, b, s, jcfg.vocab_size)
    feed = _tokens(3, b, steps, jcfg.vocab_size)
    _, jc = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, s + steps)
    _, tc = TM.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks)}, s + steps,
                       impl="reference")
    for i in range(steps):
        jl, jc = JM.decode_step(jparams, jcfg, jnp.asarray(feed[:, i]), jc, s + i)
        tl, tc = TM.decode_step(tparams, tcfg, torch.from_numpy(feed[:, i]), tc,
                                s + i, impl="reference")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL,
                                   err_msg=f"step {i}")


@pytest.mark.parametrize("window", [None, 8])
def test_greedy_generate_is_bit_identical(window):
    jcfg, jparams, tcfg, tparams = make_pair(window=window)
    toks = _tokens(4, 3, 16, jcfg.vocab_size)
    jout = JM.generate(jparams, jcfg, {"tokens": jnp.asarray(toks)}, num_new_tokens=10)
    tout = TM.generate(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                       num_new_tokens=10, impl="reference")
    np.testing.assert_array_equal(tout["tokens"].numpy(), np.asarray(jout["tokens"]))
    np.testing.assert_allclose(tout["logprobs"].numpy(), np.asarray(jout["logprobs"]),
                               atol=TOL)
    assert len(set(tout["tokens"].numpy().ravel().tolist())) > 3  # not degenerate


def test_eos_generate_matches(pair):
    jcfg, jparams, tcfg, tparams = pair
    toks = _tokens(5, 3, 16, jcfg.vocab_size)
    free = TM.generate(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                       num_new_tokens=12, impl="reference")["tokens"].numpy()
    eos = int(free[0, 3])  # row 0 stops at step 3 (or earlier)
    jout = JM.generate(jparams, jcfg, {"tokens": jnp.asarray(toks)},
                       num_new_tokens=12, eos_id=eos)
    tout = TM.generate(tparams, tcfg, {"tokens": torch.from_numpy(toks)},
                       num_new_tokens=12, eos_id=eos, impl="reference")
    np.testing.assert_array_equal(tout["tokens"].numpy(), np.asarray(jout["tokens"]))
    np.testing.assert_array_equal(tout["gen_mask"].numpy(), np.asarray(jout["gen_mask"]))
    np.testing.assert_allclose(tout["logprobs"].numpy(), np.asarray(jout["logprobs"]),
                               atol=TOL)
    assert tout["gen_mask"].numpy()[0, 4:].sum() == 0


@pytest.mark.parametrize("vocab", [512, 509])  # chunked and flat CDF
@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 0, 1.0), (0.7, 0, 1.0), (1.0, 5, 1.0), (1.0, 0, 0.8), (0.9, 20, 0.9)])
def test_sample_logits_matches_with_shared_uniforms(vocab, temperature, top_k, top_p):
    rng = np.random.default_rng(vocab + top_k)
    logits = (rng.standard_normal((6, vocab)) * 2).astype(np.float32)
    key = jax.random.PRNGKey(top_k * 7 + vocab)
    u01 = np.array(jax.random.uniform(key, (6, 1)))  # the draw _sample_cdf makes
    jt, jlp = jops.sample_logits(jnp.asarray(logits), key, temperature=temperature,
                                 top_k=top_k, top_p=top_p)
    tt, tlp = tops.sample_logits(torch.from_numpy(logits), temperature=temperature,
                                 top_k=top_k, top_p=top_p, impl="reference",
                                 uniforms=torch.from_numpy(u01))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-5)
    gt, glp = tops.sample_logits(torch.from_numpy(logits), impl="reference")
    np.testing.assert_array_equal(gt.numpy(), np.asarray(jops.sample_logits(
        jnp.asarray(logits), None)[0]))


def test_sample_logits_scores_k_positions():
    logits = np.random.default_rng(9).standard_normal((2, 3, 512)).astype(np.float32)
    key = jax.random.PRNGKey(5)
    u01 = np.array(jax.random.uniform(key, (6, 1)))
    jt, jlp = jops.sample_logits(jnp.asarray(logits), key)
    tt, tlp = tops.sample_logits(torch.from_numpy(logits), impl="reference",
                                 uniforms=torch.from_numpy(u01))
    assert tt.shape == (2, 3)
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=1e-5)
