"""The port's MoE training against the JAX package on the same weights and
inputs: ``grouped_ffn``'s gradient (an ``autograd.Function`` whose backward
is the per-expert-segment ``ref.grouped_ffn_bwd_ref``) against ``jax.grad``
through the JAX package's ``custom_vjp``; the Switch load-balance loss
against the JAX ``forward``'s second output, padded and packed; reduced
granite-moe-1b-a400m's padded and packed actor and critic train steps
against the JAX package's; and its packed gradients against the port's
padded ones on the same logical inputs.

Inputs are made with numpy from a seed; model weights as
``test_torch_train_padded.make_models``.  Tolerances: the grouped FFN's
gradients 1e-5 (fp32, as ``tests/test_moe.py``'s backward test), tail rows
and empty experts exactly 0; the aux loss 1e-6 relative and the hidden
states 1e-5 (fp32, summation order); train steps as
``test_torch_train.py`` (losses and stats 1e-5 relative, parameters 1e-7
absolute after AdamW at lr 1e-5, gradients 1e-5 absolute).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.grouped_expert import grouped_ffn as j_grouped_ffn
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro.rlhf import ppo as JPPO
from repro_torch.data import packing as tpacking
from repro_torch.kernels.grouped_expert import grouped_ffn
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.optim import adamw as tadamw
from repro_torch.rlhf import ppo as TPPO
from test_torch_train import (GEN_MIXES, GRAD_TOL, JHP, PARAM_TOL, THP, _minibatches,
                              _ppo_case, _t)
from test_torch_train_padded import (OPT, assert_trees_close, check_padded_step, make_models,
                                     padded_batch)

ARCH = "granite-moe-1b-a400m"
FFN_TOL = 1e-5


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_grouped_ffn_gradient_matches_jax_custom_vjp(act):
    """Gradients of xs and the three expert weights through the Function
    against ``jax.grad`` through the interpret tier's ``custom_vjp``
    (``tests/test_moe.py::test_grouped_ffn_backward_matches_reference_grad``'s
    case): rows past sum(group_sizes) get exactly zero, and so does the
    empty expert's weights."""
    e, n, d, f = 4, 24, 16, 8
    rng = np.random.default_rng(40)
    xs = rng.standard_normal((n, d)).astype(np.float32)
    ws = [(rng.standard_normal(shape) * 0.1).astype(np.float32)
          for shape in ((e, d, f), (e, d, f), (e, f, d))]
    gs = np.array([9, 0, 11, 2], np.int32)  # sums to 22 < 24: two tail rows
    cot = np.sin(np.arange(n * d, dtype=np.float32)).reshape(n, d)

    def jloss(xs, wg, wi, wo):
        out = j_grouped_ffn(xs, jnp.asarray(gs), wg, wi, wo, act=act, block_rows=16,
                            block_ff=8, interpret=True)
        return jnp.sum(out * cot)
    want = jax.grad(jloss, argnums=(0, 1, 2, 3))(xs, *ws)
    leaves = [_t(a).requires_grad_(True) for a in (xs, *ws)]
    out = grouped_ffn(leaves[0], _t(gs), *leaves[1:], act=act)
    assert type(out.grad_fn).__name__ == "_GroupedFFNBackward"
    (out * _t(cot)).sum().backward()
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=FFN_TOL)
    assert bool((leaves[0].grad[22:] == 0).all())
    assert all(bool((leaf.grad[1] == 0).all()) for leaf in leaves[1:])


def test_grouped_ffn_gradient_keeps_the_input_dtypes():
    """bf16 inputs: the backward runs in fp32 and casts each gradient to its
    input's dtype, as the JAX ``_diff_bwd`` does."""
    rng = np.random.default_rng(41)
    xs = _t(rng.standard_normal((10, 8)).astype(np.float32)).bfloat16().requires_grad_(True)
    ws = [_t((rng.standard_normal(s) * 0.1).astype(np.float32)).bfloat16().requires_grad_(True)
          for s in ((2, 8, 8), (2, 8, 8), (2, 8, 8))]
    grouped_ffn(xs, torch.tensor([4, 6], dtype=torch.int32), *ws).sum().backward()
    assert all(t.grad.dtype == torch.bfloat16 for t in (xs, *ws))


def _packed_batch(tokens, lens):
    pb = tpacking.pack_batch(_t(tokens), lens)
    tb = {"tokens": pb.tokens, "cu_seqlens": pb.cu_seqlens, "positions": pb.positions}
    return {k: jnp.asarray(v.numpy()) for k, v in tb.items()}, tb


@pytest.mark.parametrize("packed", [False, True])
def test_aux_loss_matches_jax_forward(packed):
    """``forward(..., return_aux=True)`` gives the JAX ``forward``'s hidden
    states and load-balance loss, padded and packed; the default forward
    and ``moe_apply`` (the serving signature) stay aux-free."""
    jcfg, jp, tcfg, tp = make_models(ARCH, seed=42)
    toks = np.random.default_rng(43).integers(1, 512, (3, 9)).astype(np.int32)
    if packed:
        jb, tb = _packed_batch(toks, [9, 2, 5])
    else:
        jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks)}
    jh, jaux = JM.forward(jp, jcfg, jb, max_seqlen=9 if packed else None)
    th, taux = TM.forward(tp, tcfg, tb, impl="reference", return_aux=True,
                          max_seqlen=9 if packed else None)
    assert taux.dtype == torch.float32 and taux.dim() == 0 and float(taux) > 0
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-6)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=FFN_TOL, rtol=FFN_TOL)
    assert torch.equal(TM.forward(tp, tcfg, tb, impl="reference",
                                  max_seqlen=9 if packed else None), th)
    x = torch.ones(1, 2, tcfg.d_model)
    assert isinstance(TMOE.moe_apply(tp["layers"][0]["ffn"], tcfg, x, impl="reference"),
                      torch.Tensor)


@pytest.mark.parametrize("which", ["actor", "critic"])
def test_padded_moe_train_steps_match_jax(which):
    """Two minibatches, one AdamW update each: the port's padded step on
    reduced granite against ``make_actor_train_step`` /
    ``make_critic_train_step``."""
    check_padded_step(ARCH, which, 2, seed=44)


@pytest.mark.parametrize("which", ["actor", "critic"])
def test_packed_moe_train_steps_match_jax(which):
    """Two packed minibatches, dropless MoE over each packed cohort: the
    port's step against ``make_packed_*_train_step`` on bridged params,
    stats, updated parameters and master copies."""
    jcfg, jp, tcfg, tp = make_models(ARCH, seed=45, head="lm" if which == "actor" else "value")
    c = _ppo_case([3, 12, 1, 5], seed=46)
    jb, tb = _minibatches(c, 2, which)
    jmake = {"actor": JPPO.make_packed_actor_train_step,
             "critic": JPPO.make_packed_critic_train_step}[which]
    tmake = {"actor": TPPO.make_packed_actor_train_step,
             "critic": TPPO.make_packed_critic_train_step}[which]
    jstep = jmake(jcfg, JHP, jadamw.AdamWConfig(**OPT), max_seqlen=c["S"])
    tstep = tmake(tcfg, THP, tadamw.AdamWConfig(**OPT), impl="reference", max_seqlen=c["S"])
    jp2, jstate, jst = jstep(jp, jadamw.init(jadamw.AdamWConfig(**OPT), jp), jb)
    tp2, tstate, tst = tstep(tp, tadamw.init(tadamw.AdamWConfig(**OPT), tp), tb)
    assert set(tst) == set(jst)
    for k in jst:
        np.testing.assert_allclose(float(tst[k]), float(jst[k]), rtol=1e-5, atol=1e-7, err_msg=k)
    assert_trees_close(tp2, jp2, tcfg, PARAM_TOL)
    assert_trees_close(tstate["master"], jstate["master"], tcfg, PARAM_TOL)


@pytest.mark.parametrize("gens", GEN_MIXES[:2])
def test_packed_moe_grads_match_the_padded_ones(gens):
    """On the same logical inputs, the port's packed actor and critic losses
    and gradients on reduced granite equal its padded ones (routing is per
    token, so packing moves no token's experts)."""
    c = _ppo_case(gens, seed=47)
    for which, head, packed_fn, padded_fn in (
            ("actor", "lm", TPPO.packed_actor_grads, TPPO.actor_grads),
            ("critic", "value", TPPO.packed_critic_grads, TPPO.critic_grads)):
        _, _, tcfg, tp = make_models(ARCH, seed=48, head=head)
        _, tb = _minibatches(c, 1, which)
        pl, _, pg = packed_fn(tp, tcfg, THP, {k: v[0] for k, v in tb.items()},
                              impl="reference", max_seqlen=c["S"])
        gen_start, _, batch = padded_batch(which, 47, gens=gens)
        dl, _, dg = padded_fn(tp, tcfg, THP, batch, gen_start, impl="reference")
        np.testing.assert_allclose(float(pl), float(dl), rtol=1e-5, atol=1e-6)
        assert len(pg) == len(dg)
        for a, b in zip(pg, dg):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=GRAD_TOL)
