"""The port's packed PPO training slice against the JAX package on the same
weights and inputs: PPO rewards and GAE (padded and packed), AdamW, the
value head, the packed actor and critic train steps, the packed gradients
against the JAX padded ones, one teacher-forced iteration of the
executors, the configs packed mode refuses (and the packed MoE forward it
takes), serving with parameters that require grad, and a CPU rehearsal of
``chip_smoke.py``'s phase 6.

Weights come from the JAX package's ``init_params`` on the reduced
qwen2-0.5b config (fp32, 2 layers) with the embedding scaled by 0.05 and
biases and norm scales randomised (as ``test_torch_model.py``), bridged
through numpy.  Tolerances (fp32; each side sums in its own order):
elementwise PPO math 1e-6 absolute; AdamW 1e-6 relative; losses and
stats 1e-5 relative; gradients 1e-5 absolute (the JAX package's own
packed-vs-padded tolerance, ``test_packed.py``); parameters after AdamW
updates at lr 1e-5, 1e-7 absolute (a hundredth of one update).  Where a
train step's update is compared, AdamW runs with eps 1e-6 instead of
1e-8: an element's first update is g / (|g| + eps), which for |g| near eps
turns on the last bits of g (the packages sum gradients in other orders,
~1e-9 apart); with eps 1e-6 that costs at most lr * 1e-9 / 1e-6 = 1e-8.
With bf16 m/v an element's state may round one bf16 step the other way
(the fp32 arithmetic before it differs in the last bit), which moves its
update by 2^-8 of lr: AdamW in bf16 is held to twice that.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.data import packing as jpacking
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.rlhf import ppo as JPPO
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.data import packing as tpacking
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.optim import adamw as tadamw
from repro_torch.rlhf import experiment as TEXP
from repro_torch.rlhf import ppo as TPPO
from repro_torch.rlhf import reward as TRWD
from test_torch_model import _dicts

HP = dict(gamma=0.97, lam=0.9, kl_coef=0.05)
JHP, THP = JPPO.PPOHyperparameters(**HP), TPPO.PPOHyperparameters(**HP)
GEN_MIXES = [
    pytest.param([3, 12, 1, 5], id="long-tail"),
    pytest.param([1, 1, 1, 1], id="all-len-1"),
    pytest.param([7, 7, 7, 7], id="all-equal"),
    pytest.param([12], id="single-max"),
]
GRAD_TOL = 1e-5
PARAM_TOL = 1e-7


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def jax_params(seed, head="lm", cfg=None):
    """(JAX params, port params) of the reduced qwen2-0.5b with shared
    weights."""
    jcfg = cfg or JARCHS["qwen2-0.5b"].reduced()
    tree = jax.tree.map(np.array, JM.init_params(jax.random.PRNGKey(seed), jcfg, head=head))
    rng = np.random.default_rng(seed)
    tree["embed"]["table"] *= 0.05
    for d in _dicts(tree):
        if "b" in d:
            d["b"] = rng.normal(0, 0.1, d["b"].shape).astype(np.float32)
        if "scale" in d:
            d["scale"] = (1 + rng.normal(0, 0.1, d["scale"].shape)).astype(np.float32)
    tcfg = get_config("qwen2-0.5b").reduced()
    return jax.tree.map(jnp.asarray, tree), params_from_jax(tree, tcfg, device="cpu")


def bridged(jtree):
    """A JAX parameter-shaped tree (params, grads) in the port's layout."""
    return params_from_jax(jax.tree.map(np.array, jtree), get_config("qwen2-0.5b").reduced(),
                           device="cpu")


def assert_trees_close(got, want_jax, atol, rtol=0.0):
    want = tadamw.leaves(bridged(want_jax))
    got = tadamw.leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=atol, rtol=rtol)


def _ppo_case(gens, P=4, G=12, seed=0):
    """Identical logical PPO inputs in both layouts (``test_packed.py``'s
    ``_ppo_case``): ``gens`` valid generated tokens per sequence."""
    g_valid = np.asarray(gens)
    b, s = len(g_valid), P + G
    rng = np.random.default_rng(seed)
    gm = (np.arange(G)[None] < g_valid[:, None]).astype(np.float32)
    c = dict(P=P, G=G, S=s, toks=rng.integers(1, 500, (b, s)).astype(np.int32), gen_mask=gm,
             logp=(rng.standard_normal((b, G)) * gm).astype(np.float32),
             ref_logp=(rng.standard_normal((b, G)) * gm).astype(np.float32),
             values=rng.standard_normal((b, G + 1)).astype(np.float32),
             rewards=rng.standard_normal(b).astype(np.float32),
             lens=P + np.minimum(g_valid + 1, G))
    z = np.zeros((b, s), np.float32)
    for name, src, lo in (("logp_full", "logp", P), ("ref_full", "ref_logp", P),
                          ("mask_full", "gen_mask", P), ("values_full", "values", P - 1)):
        c[name] = z.copy()
        c[name][:, lo:] = c[src]
    c["old_full"] = z.copy()
    c["old_full"][:, P:] = c["values"][:, :-1]
    return c


# ------------------------------------------------------------- PPO math

@pytest.mark.parametrize("gens", GEN_MIXES)
def test_shaped_rewards_and_gae_match_jax(gens):
    c = _ppo_case(gens)
    j = JPPO.shaped_rewards(JHP, jnp.asarray(c["rewards"]), jnp.asarray(c["logp"]),
                            jnp.asarray(c["ref_logp"]), jnp.asarray(c["gen_mask"]))
    t = TPPO.shaped_rewards(THP, _t(c["rewards"]), _t(c["logp"]), _t(c["ref_logp"]),
                            _t(c["gen_mask"]))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-6)
    jadv, jret = JPPO.gae(JHP, j, jnp.asarray(c["values"]), jnp.asarray(c["gen_mask"]))
    tadv, tret = TPPO.gae(THP, t, _t(c["values"]), _t(c["gen_mask"]))
    np.testing.assert_allclose(tadv.numpy(), np.asarray(jadv), atol=1e-6)
    np.testing.assert_allclose(tret.numpy(), np.asarray(jret), atol=1e-6)


@pytest.mark.parametrize("phantoms", [0, 7])
@pytest.mark.parametrize("gens", GEN_MIXES)
def test_packed_rewards_and_gae_match_jax(gens, phantoms):
    """shaped_rewards_packed, packed_last_valid and gae_packed (the port
    steps sequences side by side, the JAX package token by token), with
    and without a phantom tail."""
    c = _ppo_case(gens, seed=1)
    lens = c["lens"]
    cu = tpacking.cu_seqlens_of(lens)

    def jp(name):
        return jnp.pad(jpacking.pack(jnp.asarray(c[name]), lens), (0, phantoms))

    def tp(name):
        return torch.nn.functional.pad(tpacking.pack(_t(c[name]), lens), (0, phantoms))
    jm, tm = jp("mask_full"), tp("mask_full")
    np.testing.assert_array_equal(TPPO.packed_last_valid(tm, _t(cu)).numpy(),
                                  np.asarray(JPPO.packed_last_valid(jm, jnp.asarray(cu))))
    js = JPPO.shaped_rewards_packed(JHP, jnp.asarray(c["rewards"]), jp("logp_full"),
                                    jp("ref_full"), jm, jnp.asarray(cu))
    ts = TPPO.shaped_rewards_packed(THP, _t(c["rewards"]), tp("logp_full"), tp("ref_full"), tm,
                                    _t(cu))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    jv, tv = jp("values_full"), tp("values_full")
    jadv, jret = JPPO.gae_packed(JHP, js, JPPO.packed_shift_right(jv), jv, jm, jnp.asarray(cu))
    tadv, tret = TPPO.gae_packed(THP, ts, TPPO.packed_shift_right(tv), tv, tm, _t(cu))
    np.testing.assert_allclose(tadv.numpy(), np.asarray(jadv), atol=1e-6)
    np.testing.assert_allclose(tret.numpy(), np.asarray(jret), atol=1e-6)


def test_losses_match_jax():
    rng = np.random.default_rng(2)
    x = [rng.standard_normal((3, 9)).astype(np.float32) for _ in range(4)]
    mask = (rng.random((3, 9)) > 0.3).astype(np.float32)
    jl, jst = JPPO.actor_loss_fn(JHP, *map(jnp.asarray, x[:3]), jnp.asarray(mask))
    tl, tst = TPPO.actor_loss_fn(THP, *map(_t, x[:3]), _t(mask))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for k in jst:
        np.testing.assert_allclose(float(tst[k]), float(jst[k]), rtol=1e-5)
    np.testing.assert_allclose(float(TPPO.critic_loss_fn(THP, *map(_t, x[1:]), _t(mask))),
                               float(JPPO.critic_loss_fn(JHP, *map(jnp.asarray, x[1:]),
                                                         jnp.asarray(mask))), rtol=1e-5)


# ---------------------------------------------------------------- AdamW

@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("state_dtype,clip", [("float32", 0.5), ("bfloat16", 0.5),
                                              ("float32", 1e3)])
def test_adamw_matches_jax(steps, state_dtype, clip):
    """Random gradients, the global-norm clip active (0.5) or not (1e3),
    weight decay on the master copy, bf16 m/v."""
    cfg = dict(lr=1e-3, weight_decay=0.1, grad_clip=clip, state_dtype=state_dtype)
    jp, tp = jax_params(3)
    jstate = jadamw.init(jadamw.AdamWConfig(**cfg), jp)
    tstate = tadamw.init(tadamw.AdamWConfig(**cfg), tp)
    rng = np.random.default_rng(4)
    for i in range(steps):
        g = jax.tree.map(lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)),
                         jp)
        jp, jstate, jst = jadamw.update(jadamw.AdamWConfig(**cfg), jp, jstate, g)
        tp, tstate, tst = tadamw.update(tadamw.AdamWConfig(**cfg), tp, tstate, bridged(g),
                                        lr_scale=None)
        np.testing.assert_allclose(float(tst["grad_norm"]), float(jst["grad_norm"]), rtol=1e-6)
        np.testing.assert_allclose(float(tst["lr"]), float(jst["lr"]), rtol=1e-6)
    assert tstate["step"] == int(jstate["step"]) == steps
    tol = 1e-6 if state_dtype == "float32" else 2 * 2.0 ** -8
    assert_trees_close(tp, jp, atol=tol * cfg["lr"], rtol=1e-6)
    for k in ("m", "v", "master"):
        assert_trees_close(tstate[k], jax.tree.map(lambda a: jnp.asarray(a, jnp.float32),
                                                   jstate[k]),
                           atol=tol * cfg["lr"] if k == "master" else 1e-6,
                           rtol=1e-6 if k == "master" else tol)
    assert all(m.dtype == tadamw.DTYPES[state_dtype] for m in tadamw.leaves(tstate["m"]))


# ---------------------------------------------------------- value models

def test_value_head_scores_and_logprobs_match_jax():
    jcfg = JARCHS["qwen2-0.5b"].reduced()
    tcfg = get_config("qwen2-0.5b").reduced()
    jv, tv = jax_params(5, head="value")
    assert tv["value_head"]["w"].shape == (64, 1) and tv["value_head"]["w"].dtype == torch.float32
    assert "lm_head" not in tv
    t = TM.init_params(tcfg, seed=0, device="cpu", head="value")
    assert t["value_head"]["w"].dtype == torch.float32 and "lm_head" not in t
    toks = np.random.default_rng(6).integers(1, 512, (3, 10)).astype(np.int32)
    mask = np.ones((3, 10), np.float32)
    mask[1, 6:] = 0
    np.testing.assert_allclose(
        TRWD.score_sequences(tv, tcfg, _t(toks), _t(mask), impl="reference").numpy(),
        np.asarray(JRWD_score(jv, jcfg, toks, mask)), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        TPPO.sequence_values(tv, tcfg, _t(toks), 4, impl="reference").numpy(),
        np.asarray(JPPO.sequence_values(jv, jcfg, jnp.asarray(toks), 4, remat=False)),
        atol=1e-5, rtol=1e-5)
    jl, tl = jax_params(7)
    np.testing.assert_allclose(
        TPPO.sequence_logprobs(tl, tcfg, _t(toks), 4, impl="reference").numpy(),
        np.asarray(JPPO.sequence_logprobs(jl, jcfg, jnp.asarray(toks), 4, remat=False)),
        atol=1e-5, rtol=1e-5)


def JRWD_score(params, cfg, toks, mask):
    from repro.rlhf import reward as JRWD
    return JRWD.score_sequences(params, cfg, jnp.asarray(toks), jnp.asarray(mask))


# ------------------------------------------------------- packed train steps

def _minibatches(c, nmb, which):
    """Both packages' ``pack_minibatches`` of the actor's or the critic's
    train batch (packed advantages and returns from the JAX package's
    packed GAE, the same numbers on both sides)."""
    lens, P, S = c["lens"], c["P"], c["S"]
    cu = jnp.asarray(jpacking.cu_seqlens_of(lens))
    m_p = jpacking.pack(jnp.asarray(c["mask_full"]), lens)
    v_p = jpacking.pack(jnp.asarray(c["values_full"]), lens)
    shaped = JPPO.shaped_rewards_packed(JHP, jnp.asarray(c["rewards"]),
                                        jpacking.pack(jnp.asarray(c["logp_full"]), lens),
                                        jpacking.pack(jnp.asarray(c["ref_full"]), lens), m_p, cu)
    adv, ret = JPPO.gae_packed(JHP, shaped, JPPO.packed_shift_right(v_p), v_p, m_p, cu)
    if which == "actor":
        cols = {"logp": c["logp_full"], "adv": np.asarray(jpacking.unpack(adv, lens, S)),
                "mask": c["mask_full"]}
    else:
        cols = {"values": c["old_full"], "ret": np.asarray(jpacking.unpack(ret, lens, S)),
                "mask": c["mask_full"]}
    jb = jpacking.pack_minibatches(jnp.asarray(c["toks"]),
                                   {k: jnp.asarray(v) for k, v in cols.items()}, lens, nmb)
    tb = tpacking.pack_minibatches(_t(c["toks"]), {k: _t(v) for k, v in cols.items()}, lens, nmb)
    return jb, tb


@pytest.mark.parametrize("which", ["actor", "critic"])
def test_packed_train_steps_match_jax(which):
    """Two minibatches, one AdamW update each: the port's step against
    ``make_packed_*_train_step`` on bridged params, stats and updated
    parameters and master copies."""
    jcfg = JARCHS["qwen2-0.5b"].reduced()
    tcfg = get_config("qwen2-0.5b").reduced()
    c = _ppo_case([3, 12, 1, 5], seed=8)
    jb, tb = _minibatches(c, 2, which)
    jp, tp = jax_params(9, head="lm" if which == "actor" else "value")
    opt = dict(lr=1e-5, grad_clip=1.0, eps=1e-6)
    jmake = {"actor": JPPO.make_packed_actor_train_step,
             "critic": JPPO.make_packed_critic_train_step}[which]
    tmake = {"actor": TPPO.make_packed_actor_train_step,
             "critic": TPPO.make_packed_critic_train_step}[which]
    jstep = jmake(jcfg, JHP, jadamw.AdamWConfig(**opt), max_seqlen=c["S"])
    tstep = tmake(tcfg, THP, tadamw.AdamWConfig(**opt), impl="reference", max_seqlen=c["S"])
    jp2, jstate, jst = jstep(jp, jadamw.init(jadamw.AdamWConfig(**opt), jp), jb)
    tp2, tstate, tst = tstep(tp, tadamw.init(tadamw.AdamWConfig(**opt), tp), tb)
    assert set(tst) == set(jst)
    for k in jst:
        np.testing.assert_allclose(float(tst[k]), float(jst[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert_trees_close(tp2, jp2, atol=PARAM_TOL)
    assert_trees_close(tstate["master"], jstate["master"], atol=PARAM_TOL)


@pytest.mark.parametrize("gens", GEN_MIXES)
def test_packed_grads_match_jax_padded(gens):
    """The contract of ``test_packed.py``'s headline test, across the
    packages: the port's packed actor and critic losses and gradients equal
    the JAX package's padded ones on the same logical inputs."""
    jcfg = JARCHS["qwen2-0.5b"].reduced()
    tcfg = get_config("qwen2-0.5b").reduced()
    c = _ppo_case(gens, seed=10)
    lens, P, S = c["lens"], c["P"], c["S"]
    shaped = JPPO.shaped_rewards(JHP, jnp.asarray(c["rewards"]), jnp.asarray(c["logp"]),
                                 jnp.asarray(c["ref_logp"]), jnp.asarray(c["gen_mask"]))
    adv, ret = JPPO.gae(JHP, shaped, jnp.asarray(c["values"]), jnp.asarray(c["gen_mask"]))
    toks, gm = jnp.asarray(c["toks"]), jnp.asarray(c["gen_mask"])
    for which, head in (("actor", "lm"), ("critic", "value")):
        jp, tp = jax_params(11, head=head)
        if which == "actor":
            def padded(p):
                nl = JPPO.sequence_logprobs(p, jcfg, toks, P, remat=False)
                return JPPO.actor_loss_fn(JHP, nl, jnp.asarray(c["logp"]), adv, gm)[0]
            fn = TPPO.packed_actor_grads
        else:
            def padded(p):
                v = JPPO.sequence_values(p, jcfg, toks, P, remat=False)
                return JPPO.critic_loss_fn(JHP, v[:, :-1], jnp.asarray(c["values"][:, :-1]),
                                           ret, gm)
            fn = TPPO.packed_critic_grads
        jl, jg = jax.value_and_grad(padded)(jp)
        _, tb = _minibatches(c, 1, which)
        tl, _, tg = fn(tp, tcfg, THP, {k: v[0] for k, v in tb.items()}, impl="reference",
                       max_seqlen=S)
        np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-6)
        want = tadamw.leaves(bridged(jg))
        assert len(tg) == len(want)
        for g, w in zip(tg, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=GRAD_TOL)


# ------------------------------------------------------------ executors

def test_executors_teacher_forced_iteration_matches_jax():
    """One packed PPO iteration: the JAX package's executors generate the
    rollout; the port's ``build_executors`` (reference tier) takes that
    rollout and the same weights, and its reference logprobs, values,
    rewards, train stats and updated parameters match the JAX package's."""
    from repro.core.plan import Cluster
    from repro.rlhf.experiment import ExperimentConfig, RLHFExperiment
    jcfg = JARCHS["qwen2-0.5b"].reduced()
    tcfg = get_config("qwen2-0.5b").reduced()
    kw = dict(batch=4, prompt_len=8, gen_len=8, eos_id=3, packed_training=True)
    e = RLHFExperiment(jcfg, jcfg, Cluster(n_nodes=1, devs_per_node=1),
                       ExperimentConfig(ppo=JPPO.PPOHyperparameters(n_minibatches=2),
                                        opt=jadamw.AdamWConfig(eps=1e-6), **kw),
                       search=False)
    texp = TEXP.ExperimentConfig(ppo=TPPO.PPOHyperparameters(n_minibatches=2), impl="reference",
                                 opt=tadamw.AdamWConfig(eps=1e-6), **kw)
    models = {}
    for name in ("actor", "ref", "critic", "reward"):
        ms = e.models[name]  # the embedding scaled as everywhere (one-hot otherwise)
        ms.params = dict(ms.params, embed={"table": ms.params["embed"]["table"] * 0.05})
        if ms.opt_state is not None:
            ms.opt_state = jadamw.init(e.exp.opt, ms.params)
        models[name] = TEXP.ModelState(bridged(ms.params))
    for name in ("actor", "critic"):
        for p in tadamw.leaves(models[name].params):
            p.requires_grad_(True)
        models[name].opt_state = tadamw.init(texp.opt, models[name].params)
    ex = TEXP.build_executors(tcfg, tcfg, texp)

    roll = e.executors["actor_gen"](e.models["actor"],
                                    {"prompts": e.make_prompts(jax.random.PRNGKey(0))})
    for name in ("ref", "critic", "reward"):
        roll |= e.executors[f"{name}_inf"](e.models[name], roll)
    troll = {k: _t(roll[k]) for k in ("seq", "logp", "gen_mask")}
    for name, key in (("ref", "ref_logp"), ("critic", "values"), ("reward", "rewards")):
        out = ex[f"{name}_inf"](models[name], troll)
        assert out[key].grad_fn is None
        np.testing.assert_allclose(out[key].numpy(), np.asarray(roll[key]), atol=1e-5,
                                   rtol=1e-5, err_msg=key)
        troll[key] = _t(roll[key])  # train on the JAX package's numbers
    for name, key in (("actor", "actor_stats"), ("critic", "critic_stats")):
        got = ex[f"{name}_train"](models[name], troll)[key]
        want = e.executors[f"{name}_train"](e.models[name], roll)[key]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=f"{name} {k}")
        assert_trees_close(models[name].params, e.models[name].params, atol=PARAM_TOL)


def test_executors_refuse_what_is_not_ported():
    """The JAX package's default experiment (padded training) builds, and
    with a draft model its seven speculative executors; the unfused sampler
    and packed training of a recurrent model still raise."""
    tcfg = get_config("qwen2-0.5b").reduced()
    ex = TEXP.build_executors(tcfg, tcfg, TEXP.ExperimentConfig())
    assert set(ex) == {"actor_gen", "reward_inf", "ref_inf", "critic_inf", "actor_train",
                       "critic_train"}
    draft = TEXP.ModelState(TM.init_params(tcfg, seed=0, device="cpu"))
    ex = TEXP.build_executors(tcfg, tcfg, TEXP.ExperimentConfig(draft_model=tcfg), draft=draft)
    assert set(ex) == {"actor_gen", "draft_gen", "reward_inf", "ref_inf", "critic_inf",
                       "actor_train", "critic_train"}
    with pytest.raises(NotImplementedError, match="fused"):
        TEXP.build_executors(tcfg, tcfg, TEXP.ExperimentConfig(fused_sampling=False))
    rcfg = get_config("mamba2-1.3b").reduced()
    with pytest.raises(NotImplementedError, match="attention-only"):
        TEXP.build_executors(rcfg, rcfg, TEXP.ExperimentConfig(packed_training=True))


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "recurrentgemma-9b", "granite-moe-1b-a400m"])
def test_packed_forward_raises_on_recurrent_and_moe(arch):
    """A recurrent mixer would scan across the packed sequences: the packed
    forward raises.  The packed MoE forward runs, and each sequence's hidden
    states equal the padded forward's on its valid tokens (routing is per
    token)."""
    cfg = get_config(arch).reduced()
    params = TM.init_params(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(16).integers(1, 512, (2, 8)))
    lens = [4, 6]
    pb = tpacking.pack_batch(toks, lens)
    packed = {"tokens": pb.tokens, "cu_seqlens": pb.cu_seqlens, "positions": pb.positions}
    if cfg.ffn_kind != "moe":
        with pytest.raises(NotImplementedError):
            TM.forward(params, cfg, packed, impl="reference")
        return
    got = TM.forward(params, cfg, packed, impl="reference")[0]
    want = TM.forward(params, cfg, {"tokens": toks}, impl="reference")
    torch.testing.assert_close(got, tpacking.pack(want, lens), rtol=1e-5, atol=1e-6)


def test_packed_forward_remat_matches_and_recomputes():
    """remat gives the same loss and gradients, and its backward runs each
    layer's attention a second time."""
    tcfg = get_config("qwen2-0.5b").reduced()
    _, tp = jax_params(12)
    pb = tpacking.pack_batch(_t(np.random.default_rng(13).integers(1, 512, (3, 9))), [9, 2, 5])
    batch = {"tokens": pb.tokens, "cu_seqlens": pb.cu_seqlens, "positions": pb.positions}
    calls = [0]
    real = ops.varlen_mha

    def counted(*a, **k):
        calls[0] += 1
        return real(*a, **k)
    out = []
    for remat in (False, True):
        calls[0] = 0
        leaves = tadamw.leaves(tp)
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            ops.varlen_mha = counted
            try:
                h = TM.forward(tp, tcfg, batch, impl="reference", remat=remat, max_seqlen=9)
                loss = h.float().square().mean()
                grads = torch.autograd.grad(loss, leaves)
            finally:
                ops.varlen_mha = real
        out.append((loss.detach(), grads, calls[0]))
    assert out[0][2] == tcfg.num_layers and out[1][2] == 2 * tcfg.num_layers
    torch.testing.assert_close(out[1][0], out[0][0], rtol=0, atol=0)
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_serving_with_params_that_require_grad():
    """The trained actor's parameters require grad; every serving entry
    point still runs (no_grad) and returns outputs without a grad_fn."""
    tcfg = get_config("qwen2-0.5b").reduced()
    _, tp = jax_params(14)
    for p in tadamw.leaves(tp):
        p.requires_grad_(True)
    toks = _t(np.random.default_rng(15).integers(1, 512, (2, 6)))
    out = TM.generate(tp, tcfg, {"tokens": toks}, num_new_tokens=3, impl="reference",
                      rng=torch.Generator().manual_seed(0))
    assert out["logprobs"].grad_fn is None and not out["logprobs"].requires_grad
    last, caches = TM.prefill(tp, tcfg, {"tokens": toks}, 9, impl="reference")
    assert last.grad_fn is None
    lg, _ = TM.decode_step(tp, tcfg, toks[:, 0], caches, 6, impl="reference")
    assert lg.grad_fn is None
    bg = TM.BucketedGenerator(tcfg, impl="reference")(tp, {"tokens": toks}, num_new_tokens=3)
    assert bg["logprobs"].grad_fn is None
    prompts = [np.arange(1, 5), np.arange(3, 12)]
    assert all(t.grad_fn is None for t in
               tserve.BatchServer(tcfg, tp, max_new=3, impl="reference").serve(prompts))
    ctoks, clps = tserve.ContinuousBatchServer(tcfg, tp, n_slots=2, max_prompt=16, max_new=3,
                                               impl="reference").serve(prompts)
    assert [len(t) for t in ctoks] == [3, 3]


# ------------------------------------------------ chip_smoke rehearsal

@pytest.fixture(scope="module")
def chip_smoke():
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    return chip_smoke


def test_chip_smoke_train_phase_on_cpu(chip_smoke, monkeypatch):
    """Phase 6 at the reduced size on the reference tier: two iterations
    update both trained models with finite stats, the comparison of the
    tiers reads 0, and the ops calls that stand in for kernel launches
    equal the prediction (plus the comparison's own train forwards)."""
    cfg = chip_smoke.get_config("qwen2-0.5b").reduced()
    exp = chip_smoke.train_experiment(batch=4, prompt_len=8, new=12, impl="reference")
    calls = {"varlen_mha": 0, "mha": 0, "decode_mha": 0}

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    for name in calls:
        monkeypatch.setattr(ops, name, count(name, getattr(ops, name)))
    tr = chip_smoke.phase_train(cfg, exp, "cpu", min_valid=2, fp32_layers=0)
    assert len(tr["iters"]) == 2
    for r in tr["iters"]:
        assert all(np.isfinite(v) for v in (*r["actor_stats"].values(),
                                            *r["critic_stats"].values()))
        for st in r["state"].values():
            assert st["finite"] and st["changed"] == st["leaves"]
        assert r["train_launches"] == {}  # no kernel on the reference tier
        assert r["padded_tokens"] == 4 * 20 and 4 * 11 <= r["tokens"] <= 4 * 20
    for c in tr["compare"].values():
        assert c["loss_err"] == c["grad_norm_err"] == c["worst_leaf_err"] == 0.0
    assert tr["predicted"] == {"flash_mha_varlen": 2 * 2 * 2 * 2 * 2, "flash_mha": 2 * 4 * 2,
                               "flash_decode": 2 * 11 * 2}
    compare = 2 * cfg.num_layers * 2  # both models' first minibatch, with remat
    assert calls == {"varlen_mha": tr["predicted"]["flash_mha_varlen"] + compare,
                     "mha": tr["predicted"]["flash_mha"],
                     "decode_mha": tr["predicted"]["flash_decode"]}
