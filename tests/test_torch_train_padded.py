"""The port's padded PPO training against the JAX package on the same weights
and inputs: the padded actor and critic train steps of reduced qwen2-0.5b,
mamba2-1.3b and recurrentgemma-9b over one and two minibatches, one
teacher-forced iteration of the padded executors (the JAX package's default
experiment), and the gradients of the kernel wrappers that the padded
forward differentiates through (``flash_mha``, ``ssd_scan``,
``rglru_scan``; each an ``autograd.Function``) against ``jax.grad`` of the
JAX references.  granite-moe-1b-a400m's padded and packed steps are in
``test_torch_moe_train.py``.

Weights come from the JAX package's ``init_params`` on the reduced config
(fp32), the embedding scaled by 0.05, biases and norm scales randomised
and the recurrent mixers' constant leaves drawn (``test_torch_ssm``),
bridged through numpy.  Tolerances are ``test_torch_train.py``'s: losses
and stats 1e-5 relative; parameters after AdamW updates at lr 1e-5 with
eps 1e-6, 1e-7 absolute (``PARAM_TOL``); gradients 1e-5 absolute
(``GRAD_TOL``), the SSD scan's 1e-4 (the JAX package's own SSD tolerance,
its chunked decays being differences of cumulative sums).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.kernels import ref as jref
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.rlhf import ppo as JPPO
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.kernels.flash_attention import flash_mha
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.optim import adamw as tadamw
from repro_torch.rlhf import experiment as TEXP
from repro_torch.rlhf import ppo as TPPO
from test_torch_ssm import _dicts, randomize_mixers
from test_torch_train import GRAD_TOL, JHP, PARAM_TOL, THP, _np, _ppo_case, _t

SCAN_TOL = 1e-4
OPT = dict(lr=1e-5, grad_clip=1.0, eps=1e-6)


def make_models(arch, seed, head="lm"):
    """(jax cfg, jax params, port cfg, port params) of the reduced ``arch``
    with shared weights and a ``head`` ("lm" or "value")."""
    jcfg, tcfg = JARCHS[arch].reduced(), TARCHS[arch].reduced()
    tree = jax.tree.map(np.array, JM.init_params(jax.random.PRNGKey(seed), jcfg, head=head))
    rng = np.random.default_rng(seed)
    tree["embed"]["table"] *= 0.05
    for d in _dicts(tree):
        if "b" in d:
            d["b"] = rng.normal(0, 0.1, d["b"].shape).astype(d["b"].dtype)
        if "scale" in d:
            d["scale"] = (1 + rng.normal(0, 0.1, d["scale"].shape)).astype(d["scale"].dtype)
    randomize_mixers(tree, rng)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_jax(tree, tcfg, device="cpu")


def assert_trees_close(got, want_jax, tcfg, atol):
    want = tadamw.leaves(params_from_jax(jax.tree.map(np.array, want_jax), tcfg, device="cpu"))
    got = tadamw.leaves(got)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), _np(w), atol=atol)


def padded_batch(which, seed, gens=(3, 12, 1, 5)):
    """The padded actor or critic train batch of ``_ppo_case(gens)`` in both
    packages, advantages and returns from the JAX package's GAE."""
    c = _ppo_case(list(gens), seed=seed)
    gm = jnp.asarray(c["gen_mask"])
    shaped = JPPO.shaped_rewards(JHP, jnp.asarray(c["rewards"]), jnp.asarray(c["logp"]),
                                 jnp.asarray(c["ref_logp"]), gm)
    adv, ret = JPPO.gae(JHP, shaped, jnp.asarray(c["values"]), gm)
    if which == "actor":
        cols = {"logp": c["logp"], "adv": np.asarray(adv)}
    else:
        cols = {"values": c["values"][:, :-1], "ret": np.asarray(ret)}
    cols |= {"tokens": c["toks"], "mask": c["gen_mask"]}
    return c["P"], {k: jnp.asarray(v) for k, v in cols.items()}, {k: _t(v) for k, v in
                                                                   cols.items()}


def check_padded_step(arch, which, nmb, seed):
    """The port's padded step against the JAX package's on bridged params:
    stats, updated parameters and master copies."""
    jcfg, jp, tcfg, tp = make_models(arch, seed, head="lm" if which == "actor" else "value")
    gen_start, jb, tb = padded_batch(which, seed + 1)
    jmake = {"actor": JPPO.make_actor_train_step, "critic": JPPO.make_critic_train_step}[which]
    tmake = {"actor": TPPO.make_actor_train_step, "critic": TPPO.make_critic_train_step}[which]
    jhp, thp = (type(hp)(**{**hp.__dict__, "n_minibatches": nmb}) for hp in (JHP, THP))
    jstep = jmake(jcfg, jhp, jadamw.AdamWConfig(**OPT), gen_start)
    tstep = tmake(tcfg, thp, tadamw.AdamWConfig(**OPT), gen_start, impl="reference")
    jp2, jstate, jst = jstep(jp, jadamw.init(jadamw.AdamWConfig(**OPT), jp), jb)
    tp2, tstate, tst = tstep(tp, tadamw.init(tadamw.AdamWConfig(**OPT), tp), tb)
    assert tstate["step"] == nmb
    assert set(tst) == set(jst)
    for k in jst:
        np.testing.assert_allclose(float(tst[k]), float(jst[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert_trees_close(tp2, jp2, tcfg, PARAM_TOL)
    assert_trees_close(tstate["master"], jstate["master"], tcfg, PARAM_TOL)


@pytest.mark.parametrize("arch,which,nmb", [
    ("qwen2-0.5b", "actor", 1), ("qwen2-0.5b", "critic", 2), ("mamba2-1.3b", "actor", 2),
    ("mamba2-1.3b", "critic", 2), ("recurrentgemma-9b", "actor", 2),
    ("recurrentgemma-9b", "critic", 2)])
def test_padded_train_steps_match_jax(arch, which, nmb):
    """One or two minibatches, one AdamW update each: the port's step against
    ``make_actor_train_step`` / ``make_critic_train_step``."""
    check_padded_step(arch, which, nmb, seed=20)


def test_split_minibatches_is_the_jax_reshape():
    batch = {"tokens": torch.arange(24).reshape(6, 4), "mask": torch.ones(6, 3)}
    mbs = TPPO.split_minibatches(batch, 3)
    assert mbs["tokens"].shape == (3, 2, 4) and mbs["mask"].shape == (3, 2, 3)
    np.testing.assert_array_equal(mbs["tokens"].numpy(),
                                  np.arange(24).reshape(6, 4).reshape(3, 2, 4))
    with pytest.raises(ValueError, match="minibatches"):
        TPPO.split_minibatches(batch, 4)


# ------------------------------------------------------------ executors

def test_padded_executors_teacher_forced_iteration_matches_jax():
    """One iteration of the JAX package's default experiment (padded
    training): its executors generate the rollout; the port's
    ``build_executors`` (reference tier) takes that rollout and the same
    weights, and its inference outputs, train stats and updated parameters
    match the JAX package's."""
    from repro.core.plan import Cluster
    from repro.rlhf.experiment import ExperimentConfig, RLHFExperiment
    jcfg, tcfg = JARCHS["qwen2-0.5b"].reduced(), TARCHS["qwen2-0.5b"].reduced()
    kw = dict(batch=4, prompt_len=8, gen_len=8, eos_id=3)
    e = RLHFExperiment(jcfg, jcfg, Cluster(n_nodes=1, devs_per_node=1),
                       ExperimentConfig(ppo=JPPO.PPOHyperparameters(n_minibatches=2),
                                        opt=jadamw.AdamWConfig(eps=1e-6), **kw),
                       search=False)
    texp = TEXP.ExperimentConfig(ppo=TPPO.PPOHyperparameters(n_minibatches=2), impl="reference",
                                 opt=tadamw.AdamWConfig(eps=1e-6), **kw)
    assert not texp.packed_training and not e.exp.packed_training
    models = {}
    for name in ("actor", "ref", "critic", "reward"):
        ms = e.models[name]  # the embedding scaled as everywhere (one-hot otherwise)
        ms.params = dict(ms.params, embed={"table": ms.params["embed"]["table"] * 0.05})
        if ms.opt_state is not None:
            ms.opt_state = jadamw.init(e.exp.opt, ms.params)
        models[name] = TEXP.ModelState(params_from_jax(jax.tree.map(np.array, ms.params),
                                                       tcfg, device="cpu"))
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
        np.testing.assert_allclose(out[key].numpy(), np.asarray(roll[key]), atol=1e-5,
                                   rtol=1e-5, err_msg=key)
        troll[key] = _t(roll[key])  # train on the JAX package's numbers
    for name, key in (("actor", "actor_stats"), ("critic", "critic_stats")):
        got = ex[f"{name}_train"](models[name], troll)[key]
        want = e.executors[f"{name}_train"](e.models[name], roll)[key]
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-7, err_msg=f"{name} {k}")
        assert_trees_close(models[name].params, e.models[name].params, tcfg, PARAM_TOL)


# --------------------------------------------------- the kernels' gradients

def _jax_grads(fn, args, cots, argnums):
    """jax.grad of sum(out * cot) over ``fn(*args)``'s outputs."""
    def loss(*a):
        out = fn(*a)
        out = out if isinstance(out, tuple) else (out,)
        return sum(jnp.sum(o * c) for o, c in zip(out, cots))
    return jax.grad(loss, argnums=argnums)(*args)


def _torch_grads(fn, args, cots, argnums):
    leaves = [_t(a).requires_grad_(i in argnums) for i, a in enumerate(args)]
    out = fn(*leaves)
    out = out if isinstance(out, tuple) else (out,)
    torch.autograd.backward(out, [_t(c) for c in cots])
    return out, [leaves[i].grad for i in argnums]


# (causal, window, positions): the base case, then each argument perturbed
MHA_CASES = {"base": (True, None, False), "not-causal": (False, None, False),
             "window": (True, 5, False), "positions": (True, None, True)}


@pytest.mark.parametrize("case", list(MHA_CASES))
def test_flash_mha_gradient_matches_jax(case):
    """``flash_mha``'s gradient (the plain version's autograd, recomputed
    with the forward's mask arguments) against ``jax.grad`` of the JAX
    package's ``mha_ref``; a perturbed causal flag, window or positions
    moves the gradient away from the base case's, so the backward follows
    each of them."""
    rng = np.random.default_rng(30)
    q = rng.standard_normal((2, 12, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, 12, 2, 16)).astype(np.float32) for _ in range(2))
    cot = rng.standard_normal(q.shape).astype(np.float32)

    def grads(causal, window, positions):
        kw = dict(causal=causal, window=window)
        if positions:  # queries 4 positions past their keys: 4 more keys each
            kw |= dict(q_positions=np.arange(12)[None] + 4, kv_positions=np.arange(12)[None])
        tkw = {n: _t(a) if isinstance(a, np.ndarray) else a for n, a in kw.items()}
        jkw = {n: jnp.asarray(a) if isinstance(a, np.ndarray) else a for n, a in kw.items()}
        out, got = _torch_grads(lambda *a: flash_mha(*a, **tkw), (q, k, v), (cot,), (0, 1, 2))
        assert type(out[0].grad_fn).__name__ == "_FlashAttentionBackward"
        want = _jax_grads(lambda *a: jref.mha_ref(*a, **jkw), (q, k, v), (cot,), (0, 1, 2))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL)
        return got
    got = grads(*MHA_CASES[case])
    if case != "base":
        base = grads(*MHA_CASES["base"])
        assert max((g - b).abs().max().item() for g, b in zip(got, base)) > 1e-3


@pytest.mark.parametrize("init", [False, True])
def test_ssd_scan_gradient_matches_jax(init):
    """``ssd_scan``'s gradient over y and the final state (autograd of the
    plain version at the caller's chunk) against ``jax.grad`` of the JAX
    package's ``ssd_ref``, with and without an initial state."""
    rng = np.random.default_rng(31)
    b, s, h, p, n = 2, 32, 3, 8, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_log = (rng.standard_normal(h) * 0.5).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    d = rng.standard_normal(h).astype(np.float32)
    args = [x, dt, a_log, bm, cm, d]
    if init:
        args.append(rng.standard_normal((b, h, p, n)).astype(np.float32))
    cots = (rng.standard_normal(x.shape).astype(np.float32),
            rng.standard_normal((b, h, p, n)).astype(np.float32))
    argnums = tuple(range(len(args)))

    def port(*a):
        return ssd_scan(*a[:6], chunk=8, init_state=a[6] if init else None, return_state=True)

    def jax_ref(*a):
        return jref.ssd_ref(*a[:6], chunk=8, init_state=a[6] if init else None,
                            return_state=True)
    out, got = _torch_grads(port, args, cots, argnums)
    assert type(out[0].grad_fn).__name__ == "_SSDScanBackward"
    want = _jax_grads(jax_ref, args, cots, argnums)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=SCAN_TOL, rtol=SCAN_TOL)


@pytest.mark.parametrize("s,init", [(17, False), (64, True)])
def test_rglru_scan_gradient_matches_jax(s, init):
    """``rglru_scan``'s gradient over h and the final state (the recurrence
    run in reverse) against ``jax.grad`` of the JAX package's
    ``rglru_scan_ref``."""
    rng = np.random.default_rng(32)
    a = rng.uniform(0.3, 1.0, (2, s, 8)).astype(np.float32)
    bx = rng.standard_normal((2, s, 8)).astype(np.float32)
    args = [a, bx] + ([rng.standard_normal((2, 8)).astype(np.float32)] if init else [])
    cots = (rng.standard_normal(a.shape).astype(np.float32),
            rng.standard_normal((2, 8)).astype(np.float32))
    argnums = tuple(range(len(args)))
    out, got = _torch_grads(rglru_scan, args, cots, argnums)
    assert type(out[0].grad_fn).__name__ == "_RGLRUScanBackward"
    want = _jax_grads(jref.rglru_scan_ref, args, cots, argnums)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=GRAD_TOL)


def test_adamw_update_in_pieces_equals_the_whole_update(monkeypatch):
    """AdamW walks a large leaf in pieces along its first axis (bounding
    its fp32 temporaries): the parameters and the state equal the
    one-piece update's bit for bit, a transposed gradient included."""
    rng = np.random.default_rng(33)
    cfg = tadamw.AdamWConfig(lr=1e-3, weight_decay=0.1, state_dtype="bfloat16")
    params = {"e": _t(rng.standard_normal((300, 7)).astype(np.float32)),
              "v": _t(rng.standard_normal(1000).astype(np.float32))}
    grads = {"e": _t(rng.standard_normal((7, 300)).astype(np.float32)).T,
             "v": _t(rng.standard_normal(1000).astype(np.float32))}
    runs = []
    for piece in (tadamw.PIECE, 64):
        monkeypatch.setattr(tadamw, "PIECE", piece)
        p = {k: v.clone() for k, v in params.items()}
        state = tadamw.init(cfg, p)
        for _ in range(2):
            tadamw.update(cfg, p, state, grads)
        runs.append(tadamw.leaves([p, state["m"], state["v"], state["master"]]))
    assert all(torch.equal(a, b) for a, b in zip(*runs))
