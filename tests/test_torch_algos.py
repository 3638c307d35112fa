"""The port's DPO, GRPO and ReMax (``repro_torch.rlhf.{dpo,grpo,remax}``)
and synthetic datasets (``repro_torch.data.synth``) against the JAX
package's, on the same weights and inputs.

The train steps run on reduced qwen3-1.7b (qk-norm, tied embeddings),
weights from the JAX package's ``init_params`` bridged through numpy
(``test_torch_train_padded.make_models``: embedding scaled by 0.05, biases
and norm scales randomised, so the qk-norm scales differ from 1).  Stated
tolerances are ``test_torch_train.py``'s: losses and stats 1e-5 relative;
parameters and master copies after one AdamW update at lr 1e-5, eps 1e-6,
1e-7 absolute (``PARAM_TOL``); the first and second moments as the
gradient they hold after one update (m / (1 - b1) and sqrt(v / (1 - b2))),
1e-5 absolute (``GRAD_TOL``).  Datasets and the prefetcher's order are held
bit for bit.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import synth as jsynth
from repro.optim import adamw as jadamw
from repro.rlhf import dpo as JDPO
from repro.rlhf import grpo as JGRPO
from repro.rlhf import remax as JREMAX
from repro.rlhf.ppo import sequence_logprobs as jseq_logprobs
from repro_torch import dpo_train
from repro_torch.data import synth as tsynth
from repro_torch.optim import adamw as tadamw
from repro_torch.rlhf import dpo as TDPO
from repro_torch.rlhf import grpo as TGRPO
from repro_torch.rlhf import remax as TREMAX
from test_torch_train import GRAD_TOL, PARAM_TOL, _np
from test_torch_train_padded import OPT, assert_trees_close, make_models

ARCH = "qwen3-1.7b"
STAT_RTOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------- the losses

def test_dpo_loss_matches_jax():
    rng = np.random.default_rng(0)
    pc, pr, rc, rr = (rng.normal(-40, 5, (6,)).astype(np.float32) for _ in range(4))
    for hp in (0.1, 0.5):
        jl, js = JDPO.dpo_loss(JDPO.DPOHyperparameters(hp), *map(jnp.asarray, (pc, pr, rc, rr)))
        tl, ts = TDPO.dpo_loss(TDPO.DPOHyperparameters(hp), *map(_t, (pc, pr, rc, rr)))
        np.testing.assert_allclose(float(tl), float(jl), rtol=STAT_RTOL)
        assert set(ts) == set(js)
        for k in js:
            np.testing.assert_allclose(float(ts[k]), float(js[k]), rtol=STAT_RTOL, err_msg=k)
            assert ts[k].dtype == torch.float32


def test_dpo_loss_with_the_reference_equal_to_the_policy():
    """Step 0 with reference = policy: every logit 0, loss ln 2, dpo_acc 0
    (``logits > 0`` is false at 0)."""
    lp = _t(np.random.default_rng(1).normal(-40, 5, (4,)).astype(np.float32))
    loss, stats = TDPO.dpo_loss(TDPO.DPOHyperparameters(0.1), lp, lp + 1, lp, lp + 1)
    assert abs(float(loss) - math.log(2)) < 1e-7
    assert float(stats["dpo_acc"]) == 0.0 and float(stats["margin"]) == 0.0


@pytest.mark.parametrize("group_size", [2, 3, 8])
def test_group_advantages_match_jax(group_size):
    """Population std, as jnp's ``std``; at a group of 2 the sample std is
    sqrt(2) times it, so a sample-std port would read +-1/sqrt(2)."""
    r = np.random.default_rng(group_size).normal(0, 2, (4 * group_size,)).astype(np.float32)
    want = np.asarray(JGRPO.group_advantages(jnp.asarray(r), group_size))
    got = TGRPO.group_advantages(_t(r), group_size).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    g = got.reshape(-1, group_size)
    np.testing.assert_allclose(g.mean(-1), 0, atol=1e-5)
    np.testing.assert_allclose(g.std(-1), 1, atol=1e-3)
    if group_size == 2:
        np.testing.assert_allclose(np.abs(got), 1, atol=1e-5)


# --------------------------------------------------------- the train steps

def assert_opt_state_close(tstate, jstate, tcfg):
    """m and v after one update, as the gradient they hold; the master."""
    b1, b2 = OPT.get("b1", 0.9), OPT.get("b2", 0.95)
    jm = jax.tree.map(lambda m: m / (1 - b1), jstate["m"])
    jv = jax.tree.map(lambda v: jnp.sqrt(v / (1 - b2)), jstate["v"])
    tm = [m / (1 - b1) for m in tadamw.leaves(tstate["m"])]
    tv = [torch.sqrt(v / (1 - b2)) for v in tadamw.leaves(tstate["v"])]
    assert_trees_close(tm, jm, tcfg, GRAD_TOL)
    assert_trees_close(tv, jv, tcfg, GRAD_TOL)
    assert_trees_close(tstate["master"], jstate["master"], tcfg, PARAM_TOL)


def run_both(jmake, tmake, jhp, thp, gen_start, jbatch, seed=3, tbatch=None):
    """One step of each package on bridged weights; checks loss, stats,
    parameters and AdamW state.  The port's batch is ``jbatch``'s arrays
    unless ``tbatch`` is given."""
    jcfg, jp, tcfg, tp = make_models(ARCH, seed)
    tbatch = tbatch or {k: _t(v) for k, v in jbatch.items()}
    jstep = jmake(jcfg, jhp, jadamw.AdamWConfig(**OPT), gen_start)
    tstep = tmake(tcfg, thp, tadamw.AdamWConfig(**OPT), gen_start, impl="reference")
    jp2, jstate, jst = jstep(jp, jadamw.init(jadamw.AdamWConfig(**OPT), jp),
                             {k: jnp.asarray(v) for k, v in jbatch.items()})
    tp2, tstate, tst = tstep(tp, tadamw.init(tadamw.AdamWConfig(**OPT), tp), tbatch)
    assert tstate["step"] == 1
    assert set(tst) == set(jst)
    for k in jst:
        np.testing.assert_allclose(float(tst[k]), float(jst[k]), rtol=STAT_RTOL, atol=1e-7,
                                   err_msg=k)
    assert_trees_close(tp2, jp2, tcfg, PARAM_TOL)
    assert_opt_state_close(tstate, jstate, tcfg)
    return tst


def _jax_logp(seed, tokens, gen_start):
    jcfg, jp, _, _ = make_models(ARCH, seed)
    return np.asarray(jseq_logprobs(jp, jcfg, jnp.asarray(tokens), gen_start))


@pytest.mark.parametrize("ref_is_policy", [True, False])
def test_dpo_train_step_matches_jax(ref_is_policy):
    """With ``ref_is_policy`` each package scores the reference with its own
    forward of the policy's weights (the first step of DPO: every logit 0,
    loss ln 2, dpo_acc 0 on both); else both take the JAX package's scores
    plus N(0, 1) noise."""
    jcfg, jp, tcfg, tp = make_models(ARCH, 3)
    seq, gen_start = 16, 8
    b = jsynth.PreferenceDataset(jcfg.vocab_size, seq, 4, seed=2).batch_at(0)
    b = {k: np.array(v) for k, v in b.items()}
    b["chosen_mask"][1, 12:] = 0  # a ragged pair
    tb = {k: _t(v) for k, v in b.items()}
    rng = np.random.default_rng(4)
    for side in ("chosen", "rejected"):
        ref = np.asarray(JDPO.seq_logp_sum(jp, jcfg, jnp.asarray(b[side]),
                                           jnp.asarray(b[f"{side}_mask"]), gen_start))
        if ref_is_policy:
            with torch.no_grad():
                tb[f"ref_{side}_logp"] = TDPO.seq_logp_sum(
                    tp, tcfg, tb[side], tb[f"{side}_mask"], gen_start, impl="reference",
                    remat=False)
        else:
            ref = ref + rng.normal(0, 1.0, ref.shape).astype(np.float32)
            tb[f"ref_{side}_logp"] = _t(ref)
        b[f"ref_{side}_logp"] = ref
    st = run_both(JDPO.make_dpo_train_step, TDPO.make_dpo_train_step,
                  JDPO.DPOHyperparameters(0.1), TDPO.DPOHyperparameters(0.1), gen_start, b,
                  tbatch=tb)
    if ref_is_policy:
        assert abs(float(st["loss"]) - math.log(2)) < 1e-7
        assert float(st["dpo_acc"]) == 0.0 and float(st["margin"]) == 0.0


def _rollout_batch(seed, rows, seq, gen_start):
    """tokens, a ragged mask, behaviour and reference logprobs near the
    policy's (so ratios clip and the KL terms are nonzero), rewards."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(1, 512, (rows, seq)).astype(np.int32)
    g = seq - gen_start
    lens = rng.integers(1, g + 1, (rows,))
    mask = (np.arange(g)[None] < lens[:, None]).astype(np.float32)
    lp = _jax_logp(3, toks, gen_start)
    return {"tokens": toks, "mask": mask,
            "logp": (lp + rng.normal(0, 0.3, lp.shape)).astype(np.float32),
            "ref_logp": (lp + rng.normal(0, 0.3, lp.shape)).astype(np.float32),
            "rewards": rng.normal(0, 1, (rows,)).astype(np.float32)}


@pytest.mark.parametrize("group_size", [2, 4])
def test_grpo_train_step_matches_jax(group_size):
    b = _rollout_batch(5, 8, 14, 6)
    st = run_both(JGRPO.make_grpo_train_step, TGRPO.make_grpo_train_step,
                  JGRPO.GRPOHyperparameters(group_size=group_size),
                  TGRPO.GRPOHyperparameters(group_size=group_size), 6, b)
    assert 0 < float(st["clip_frac"]) < 1


def test_remax_train_step_matches_jax():
    b = _rollout_batch(6, 4, 14, 6)
    b.pop("logp")
    b["rewards_baseline"] = np.random.default_rng(7).normal(0, 1, (4,)).astype(np.float32)
    run_both(JREMAX.make_remax_train_step, TREMAX.make_remax_train_step,
             JREMAX.ReMaxHyperparameters(), TREMAX.ReMaxHyperparameters(), 6, b)


# ------------------------------------------------------------- the datasets

def _same(got, want):
    assert set(got) == set(want)
    for k in want:
        g, w = got[k], np.asarray(want[k])
        assert g.device.type == "cpu"
        assert str(g.dtype).split(".")[-1] == w.dtype.name, k
        np.testing.assert_array_equal(g.numpy(), w, err_msg=k)


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 7), (11, 123)])
def test_datasets_give_the_jax_arrays(seed, step):
    pj = jsynth.PromptDataset(1000, 12, 5, seed=seed, min_len=4)
    pt = tsynth.PromptDataset(1000, 12, 5, seed=seed, min_len=4, device="cpu")
    _same(pt.batch_at(step), pj.batch_at(step))
    kj, kt = pj.packed_batch_at(step), pt.packed_batch_at(step)
    for f in ("tokens", "cu_seqlens", "positions"):
        np.testing.assert_array_equal(getattr(kt, f).numpy(), np.asarray(getattr(kj, f)))
    assert kt.max_len == kj.max_len and kt.tokens.dtype == torch.int32
    _same(tsynth.PreferenceDataset(700, 9, 3, seed=seed, device="cpu").batch_at(step),
          jsynth.PreferenceDataset(700, 9, 3, seed=seed).batch_at(step))
    _same(tsynth.LMDataset(300, 10, 4, seed=seed, device="cpu").batch_at(step),
          jsynth.LMDataset(300, 10, 4, seed=seed).batch_at(step))


def test_prompt_dataset_iterates_from_step_0():
    ds = tsynth.PromptDataset(50, 6, 2, seed=1, device="cpu")
    for step, batch in zip(range(3), ds):
        _same(batch, jsynth.PromptDataset(50, 6, 2, seed=1).batch_at(step))


def test_prefetcher_order():
    """The prefetch thread hands out start_step, start_step + 1, ... in
    order, as the JAX package's does."""
    ds = tsynth.LMDataset(300, 8, 2, seed=4, device="cpu")
    jds = jsynth.LMDataset(300, 8, 2, seed=4)
    pf, jpf = tsynth.Prefetcher(ds, start_step=5, depth=2), jsynth.Prefetcher(jds, start_step=5)
    try:
        for step in range(5, 11):
            got, want = pf.next(), jpf.next()
            _same(got, want)
            _same(got, jds.batch_at(step))
    finally:
        pf.close()
        jpf.close()
    assert not pf._t.is_alive()


# ------------------------------------------------------------- the entry point

def test_dpo_train_runs_on_the_cpu(capsys):
    losses = dpo_train.main(["--device", "cpu", "--steps", "3"])
    assert len(losses) == 3 and all(math.isfinite(x) for x in losses)
    assert abs(losses[0] - math.log(2)) < 1e-5
    out = capsys.readouterr().out
    assert "step   0" in out and "done" in out


def test_dpo_train_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dpo_train.main(["--steps", "1"])


def test_bridged_moments_are_gradients():
    """The moment check above reads m / (1 - b1) as the gradient: true after
    exactly one update from zeros, with the clip scale folded in."""
    cfg = tadamw.AdamWConfig(**OPT)
    p = {"w": torch.ones(3)}
    st = tadamw.init(cfg, p)
    g = [torch.tensor([0.1, -0.2, 0.3])]
    tadamw.update(cfg, p, st, g)
    np.testing.assert_allclose(_np(st["m"]["w"] / (1 - 0.9)), g[0].numpy(), rtol=1e-6)
    np.testing.assert_allclose(_np(torch.sqrt(st["v"]["w"] / (1 - 0.95))),
                               np.abs(g[0].numpy()), rtol=1e-6)
