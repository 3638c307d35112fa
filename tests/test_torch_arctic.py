"""Snowflake Arctic (arctic-480b) in the port against the JAX package: the
config, its counts and per-layer bytes, the registry's assigned cells, and
at the reduced size (2 layers of d_model 64, 4 experts top-2 of width 32, a
dense residual MLP of width 128, fp32) under both MoE dispatches the
bridged tree with its ``ffn.dense`` leaves, forward logits, prefill plus 8
teacher-forced decode steps, greedy ``generate``, and ``lm_loss`` with its
aux loss and every leaf's gradient against ``jax.grad``.  Then the
capacity dispatch at a shape that overflows (one router column scaled in
numpy, so most tokens pick expert 0): ``capacity_route`` equal element for
element, the layer's output equal to the JAX one and dependent on its
cohort; the capacity dispatch equal to the dropless one where nothing
drops; the expert-parallel train step with the dense residual split over
d_ff against the single-device step; the refusals; and the in-place
``truncated_normal`` and the dtype-buffered ``grouped_ffn_bwd_ref`` bit
for bit against the formulas they replaced.

Weights come from the JAX package's ``init_params`` bridged through numpy,
the embedding scaled by 0.05, norm scales randomised.  Tolerances: logits
within 1e-5 of the largest |logit| (``test_torch_dense_configs``),
gradients 1e-5 (``test_torch_train``), an MoE layer 2e-5
(``test_torch_moe``: the k products summed in another order); greedy tokens
and routing decisions exactly.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as JCONF
from repro.core import realloc as JR
from repro.models import model as JM
from repro.models import moe as JMOE
from repro_torch import configs as TCONF
from repro_torch.bridge import params_from_jax
from repro_torch.core import realloc as TR
from repro_torch.kernels import ref
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw as tadamw
from repro_torch.parallel import steps as TSTEPS
from test_torch_dense_configs import assert_logits_close, assert_logprobs_close
from test_torch_model import _dicts
from test_torch_tp_step import assert_close_runs, cpu_mesh, sharded_step, single_step
from test_torch_train import GRAD_TOL, _np

ARCH = "arctic-480b"
DISPATCHES = ("dropless", "capacity")
MOE_TOL = 2e-5
JDECODE = jax.jit(JM.decode_step, static_argnums=(1,))


@functools.lru_cache(maxsize=None)
def make_pair(dispatch, seed=0):
    """(jax cfg, jax params, port cfg, port params) of reduced Arctic under
    ``dispatch``, with shared weights."""
    jcfg = JCONF.ARCHS[ARCH].reduced(moe_dispatch=dispatch)
    tcfg = TCONF.ARCHS[ARCH].reduced(moe_dispatch=dispatch)
    tree = jax.tree.map(np.array, JM.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    tree["embed"]["table"] *= 0.05
    for d in _dicts(tree):
        if "scale" in d:
            d["scale"] = (1 + rng.normal(0, 0.1, d["scale"].shape)).astype(np.float32)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_jax(tree, tcfg, device="cpu")


@pytest.fixture(scope="module", params=DISPATCHES)
def pair(request):
    return make_pair(request.param)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(1, vocab, shape).astype(np.int32)


# ------------------------------------------------------------- the config

@pytest.mark.parametrize("reduced", [False, True])
def test_config_counts_and_layer_bytes_equal_jax(reduced):
    jc, tc = JCONF.ARCHS[ARCH], TCONF.get_config(ARCH)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    assert dataclasses.asdict(jc) == dataclasses.asdict(tc)
    assert tc.dense_residual_ffn and tc.moe_dispatch == "dropless"
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert TR.layer_bytes(tc) == JR.layer_bytes(jc)


def test_full_width_shapes():
    """What phase 14 runs: 128 experts of (7,168 x 4,864) beside a dense
    residual MLP of the same width; one layer is 27.2 GB in bf16, an expert
    weight 4.46e9 elements (past 2^31)."""
    c = TCONF.get_config(ARCH)
    assert (c.n_experts, c.top_k, c.d_model, c.expert_d_ff, c.d_ff) == (128, 2, 7168, 4864, 4864)
    assert (c.n_heads, c.n_kv_heads, c.head_dim, c.vocab_size) == (56, 8, 128, 32000)
    assert not c.tie_embeddings and c.num_layers == 35
    assert c.n_experts * c.d_model * c.expert_d_ff > 2 ** 31
    assert round(TR.layer_bytes(c)[1] / 1e9, 1) == 27.2
    assert round(c.param_count() / 1e9) == 477


def test_registry_equals_jax():
    assert TCONF.ASSIGNED == JCONF.ASSIGNED and set(TCONF.ARCHS) == set(JCONF.ARCHS)
    assert {k: dataclasses.astuple(v) for k, v in TCONF.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in JCONF.SHAPES.items()}
    for skipped in (False, True):
        assert list(TCONF.all_cells(include_skipped=skipped)) == \
            list(JCONF.all_cells(include_skipped=skipped))
    for name in TCONF.ASSIGNED:
        assert dataclasses.asdict(TCONF.ARCHS[name]) == dataclasses.asdict(JCONF.ARCHS[name])
        for s in TCONF.SHAPES:
            assert TCONF.cell_supported(TCONF.ARCHS[name], TCONF.SHAPES[s]) == \
                JCONF.cell_supported(JCONF.ARCHS[name], JCONF.SHAPES[s])


def test_unknown_dispatch_raises():
    with pytest.raises(ValueError, match="moe_dispatch"):
        TCONF.get_config(ARCH).reduced(moe_dispatch="top1")


def test_bridge_carries_every_leaf():
    """Every leaf of every layer, the dense residual's included, is the
    JAX package's layer slice."""
    _, jp, tcfg, tp = make_pair("dropless")
    group = jax.tree.map(np.asarray, jp["groups"][0]["b0"])
    for i, layer in enumerate(tp["layers"]):
        assert set(layer["ffn"]) == {"router", "w_gate", "w_in", "w_out", "dense"}
        assert layer["ffn"]["dense"]["w_out"]["w"].shape == (tcfg.d_ff, tcfg.d_model)
        got = jax.tree_util.tree_leaves_with_path(jax.tree.map(lambda t: t.numpy(), layer))
        want = jax.tree_util.tree_leaves_with_path(group)
        assert [p for p, _ in got] == [p for p, _ in want]
        for (path, g), (_, w) in zip(got, want):
            np.testing.assert_array_equal(g, w[i], err_msg=str(path))


# --------------------------------------------------------------- the model

def test_forward_logits_match_jax(pair):
    jcfg, jp, tcfg, tp = pair
    toks = _tokens(1, (2, 24), jcfg.vocab_size)
    jh, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, remat=False)
    th = TM.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)}, impl="reference")
    assert_logits_close(TM.logits_of(tp, tcfg, th).numpy(), JM.logits_of(jp, jcfg, jh))


def test_teacher_forced_decode_matches_jax(pair):
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


def test_greedy_generate_is_bit_identical(pair):
    jcfg, jp, tcfg, tp = pair
    toks = _tokens(4, (3, 16), jcfg.vocab_size)
    jout = JM.generate(jp, jcfg, {"tokens": jnp.asarray(toks)}, num_new_tokens=8)
    tout = TM.generate(tp, tcfg, {"tokens": torch.from_numpy(toks)}, num_new_tokens=8,
                       impl="reference")
    np.testing.assert_array_equal(tout["tokens"].numpy(), np.asarray(jout["tokens"]))
    assert_logprobs_close(tout["logprobs"].numpy(), jout["logprobs"])
    assert len(set(tout["tokens"].numpy().ravel().tolist())) > 3  # not degenerate


def test_lm_loss_aux_and_grads_match_jax(pair):
    """``lm_loss``, its aux loss and the gradient in every leaf (the dense
    residual's and the experts' included) against ``jax.grad``."""
    jcfg, jp, tcfg, tp = pair
    toks = _tokens(5, (2, 16), jcfg.vocab_size)
    labels = _tokens(6, (2, 16), jcfg.vocab_size)
    mask = np.ones((2, 16), np.float32)
    mask[1, 11:] = 0.0
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels), "mask": jnp.asarray(mask)}
    tb = {"tokens": torch.from_numpy(toks).long(), "labels": torch.from_numpy(labels).long(),
          "mask": torch.from_numpy(mask)}
    (jl, jstats), jg = jax.value_and_grad(
        lambda p: JM.lm_loss(p, jcfg, jb, remat=False), has_aux=True)(jp)
    tp = tadamw._map(lambda t: t.clone().requires_grad_(True), tp)
    tl, tstats = TM.lm_loss(tp, tcfg, tb, impl="reference", remat=True)
    tl.backward()
    np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
    np.testing.assert_allclose(tstats["aux_loss"].item(), float(jstats["aux_loss"]), rtol=1e-5)
    assert float(jstats["aux_loss"]) > 0
    want = tadamw.leaves(params_from_jax(jax.tree.map(np.array, jg), tcfg, device="cpu"))
    got = tadamw.leaves(tp)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g.grad), _np(w), atol=GRAD_TOL)
    assert float(tp["layers"][0]["ffn"]["dense"]["w_out"]["w"].grad.abs().max()) > 0


# ------------------------------------------------------- capacity dispatch

def overflow_case(seed=0, t=24, boost=4.0):
    """A layer of reduced Arctic (capacity dispatch) whose router column 0
    is scaled by ``boost`` in numpy, and t tokens of normal inputs shifted
    by twice that column's unit vector: almost every token routes to expert
    0, past its capacity.  Returns (jax cfg, jax layer params, port cfg,
    port layer params, x (1, t, D))."""
    jcfg, jp, tcfg, _ = make_pair("capacity")
    layer = jax.tree.map(lambda a: np.array(a[0]), jp["groups"][0]["b0"]["ffn"])
    w0 = layer["router"]["w"][:, 0]
    x = np.random.default_rng(seed).standard_normal((1, t, jcfg.d_model))
    x = (x + 2 * w0 / np.linalg.norm(w0)).astype(np.float32)
    layer["router"]["w"][:, 0] *= boost
    return (jcfg, jax.tree.map(jnp.asarray, layer), tcfg,
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), layer), x)


def test_capacity_route_equals_jax_when_overflowing():
    jcfg, jl, tcfg, tl, x = overflow_case()
    t = x.shape[1]
    _, jw, ji = JMOE._router(jl, jcfg, jnp.asarray(x[0]))
    want = [np.asarray(a) for a in JMOE.capacity_route(jcfg, jw, ji, t)]
    got = TMOE.capacity_route(tcfg, torch.from_numpy(np.array(jw)),
                              torch.from_numpy(np.array(ji)).long(), t)
    assert got[-1] == want[-1] == TMOE.capacity(t, tcfg) == 15
    for name, g, w in zip(("order", "st", "slot", "keep", "sw"), got[:-1], want[:-1]):
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    assert got[4].dtype == torch.float32
    assert (~got[3]).sum() >= 4  # it overflows: assignments dropped


def test_capacity_dispatch_overflows_like_jax_and_depends_on_the_cohort():
    """The layer's output at the overflowing shape equals the JAX one; a
    token that lost an expert in the 24-token cohort gets another output
    alone (4 tokens: capacity 8, nothing drops), which also equals the JAX
    one."""
    jcfg, jl, tcfg, tl, x = overflow_case()
    jy, _ = JMOE.moe_apply(jl, jcfg, jnp.asarray(x))
    ty = TMOE.moe_apply(tl, tcfg, torch.from_numpy(x), impl="reference")
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=MOE_TOL)
    top_w, top_i = TMOE._router(tl, tcfg, torch.from_numpy(x[0]))
    keep = TMOE.capacity_route(tcfg, top_w, top_i, x.shape[1])[3]
    order, _ = TMOE._sort_by_expert(top_i, tcfg.top_k)
    lost = torch.zeros(top_i.numel(), dtype=torch.bool).scatter_(0, order, ~keep)
    rows = torch.nonzero(lost.view(-1, tcfg.top_k).any(-1))[:, 0][:4]
    assert rows.numel() == 4
    sub = x[:, rows.numpy()]
    alone = TMOE.moe_apply(tl, tcfg, torch.from_numpy(sub), impl="reference")
    assert float((alone - ty[:, rows]).abs().max()) > 1e-4
    jalone, _ = JMOE.moe_apply(jl, jcfg, jnp.asarray(sub))
    np.testing.assert_allclose(alone.numpy(), np.asarray(jalone), atol=MOE_TOL)


def test_capacity_equals_dropless_when_nothing_drops():
    """4 tokens: capacity 8 >= every expert's load, so every assignment is
    kept and the two dispatches give the same output (to fp32 summation
    order), the dense residual included."""
    jcfg, jl, tcfg, tl, x = overflow_case(seed=1, t=4)
    xt = torch.from_numpy(x)
    top_w, top_i = TMOE._router(tl, tcfg, xt[0])
    assert bool(TMOE.capacity_route(tcfg, top_w, top_i, 4)[3].all())
    cap = TMOE.moe_apply(tl, tcfg, xt, impl="reference")
    drop = TMOE.moe_apply(tl, dataclasses.replace(tcfg, moe_dispatch="dropless"), xt,
                          impl="reference")
    np.testing.assert_allclose(cap.numpy(), drop.numpy(), atol=MOE_TOL)
    no_dense = TMOE.moe_apply({k: v for k, v in tl.items() if k != "dense"}, tcfg, xt,
                              impl="reference")
    assert float((no_dense - cap).abs().max()) > 1e-2  # the dense residual is in both


# ------------------------------------------------------- expert parallelism

@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_expert_parallel_step_matches_single_device(shape):
    """Experts split over the model axis, the dense residual over its d_ff
    (each rank's fp32 share summed over the axis, cast once): the train
    step equals the single-device step."""
    _, _, tcfg, tp = make_pair("dropless")
    batch = TM.synth_batch(1, tcfg, 12, 4, device="cpu")
    batch["mask"][1, 7:] = 0.0
    opt = tadamw.AdamWConfig(lr=1e-6)
    single = single_step(tcfg, tp, batch, opt)
    assert_close_runs(single, sharded_step(tcfg, tp, batch, opt, cpu_mesh(shape)))


def test_sharded_refusals():
    """The sharded steps take the capacity dispatch (held against the JAX
    package in ``test_torch_ep_moe.py``); a tensor axis that does not
    divide the dense residual's d_ff is refused no more than a dense
    FFN's: the residual runs whole on every rank beside the 3 experts split
    one a rank, or split beside them at d_ff 96, and the (1, 3) step
    equals the single-device step either way."""
    _, _, tcfg, tp = make_pair("capacity")
    TSTEPS.make_train_step(tcfg, tadamw.AdamWConfig(), impl="reference", mesh=cpu_mesh((1, 2)))
    odd = TCONF.get_config(ARCH).reduced(n_heads=3, n_kv_heads=3, n_experts=3)
    opt = tadamw.AdamWConfig(lr=1e-6)
    for cfg in (odd, dataclasses.replace(odd, d_ff=96)):
        TT.check_sharded(cfg, 3)
        params = TM.init_params(cfg, seed=2, device="cpu")
        params["embed"]["table"].mul_(0.05)
        batch = TM.synth_batch(1, cfg, 12, 2, device="cpu")
        assert_close_runs(single_step(cfg, params, batch, opt),
                          sharded_step(cfg, params, batch, opt, cpu_mesh((1, 3))))


# --------------------------------------------- init and the gradient's buffers

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_truncated_normal_keeps_its_bits(dtype):
    """The in-place scale gives the bits of ``(t * scale).to(dtype)``."""
    got = TL.truncated_normal(torch.Generator().manual_seed(3), (257, 129), dtype, 64 ** -0.5,
                              "cpu")
    t = torch.empty((257, 129), dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=torch.Generator().manual_seed(3))
    assert torch.equal(got, (t * 64 ** -0.5).to(dtype))


def _bwd_fp32_then_cast(xs, group_sizes, w_gate, w_in, w_out, grad_out, act="silu"):
    """``grouped_ffn_bwd_ref`` as it was: whole fp32 weight gradients, cast
    at the end."""
    n, d = xs.shape
    f32 = torch.float32
    dx = torch.zeros((n, d), dtype=f32)
    dws = [torch.zeros(w.shape, dtype=f32) for w in (w_gate, w_in, w_out)]
    lo = 0
    for e, end in enumerate(torch.cumsum(group_sizes, 0).tolist()):
        hi = min(int(end), n)
        if hi > lo:
            x, g = xs[lo:hi].to(f32), grad_out[lo:hi].to(f32)
            wg, wi, wo = (w[e].to(f32) for w in (w_gate, w_in, w_out))
            pre_i = x @ wi
            a, act_vjp = torch.func.vjp(ref.ACTS[act], x @ wg)
            dh = g @ wo.T
            dpre_i = dh * a
            (dpre_g,) = act_vjp(dh * pre_i)
            dx[lo:hi] = dpre_g @ wg.T + dpre_i @ wi.T
            dws[0][e] = x.T @ dpre_g
            dws[1][e] = x.T @ dpre_i
            dws[2][e] = (a * pre_i).T @ g
        lo = max(lo, hi)
    return (dx.to(xs.dtype), *(dw.to(w.dtype) for dw, w in zip(dws, (w_gate, w_in, w_out))))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_grouped_ffn_bwd_writes_the_same_bits(dtype):
    """Each expert's gradient cast straight into a buffer of the weight's
    dtype equals the whole fp32 gradient cast at the end, bit for bit
    (ragged groups, an empty expert, rows past the total)."""
    g = torch.Generator().manual_seed(4)
    e, n, d, f = 4, 40, 32, 16
    xs = torch.randn(n, d, generator=g).to(dtype)
    ws = [(torch.randn(shape, generator=g) * 0.2).to(dtype)
          for shape in ((e, d, f), (e, d, f), (e, f, d))]
    gs = torch.tensor([9, 0, 17, 11], dtype=torch.int32)
    grad_out = torch.randn(n, d, generator=g)
    got = ref.grouped_ffn_bwd_ref(xs, gs, *ws, grad_out)
    want = _bwd_fp32_then_cast(xs, gs, *ws, grad_out)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == dtype and torch.equal(a, b)
    assert not got[1][1].any() and bool(got[2][2].abs().max() > 0)
