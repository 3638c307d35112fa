"""The port's dropless MoE against the JAX package: the grouped expert FFN
(plain version and the CPU path of the kernel wrapper) against the JAX
reference and the Pallas kernel in interpret mode, the per-row expert ids,
``moe_apply``, the bridge's MoE leaves, the reduced granite-moe-1b-a400m
model's logits through every entry point, and greedy serving through both
engines.

Inputs are made with numpy from a seed and handed to both packages.
Tolerances: the grouped FFN 1e-5 (fp32, summation order only, as
``tests/test_moe.py``); ``moe_apply`` 2e-5 (the combine adds the k
products in another order, as ``test_moe.py``'s cohort test); logits and
logprobs 1e-4 (fp32 through the whole model, as ``test_torch_model.py``);
greedy tokens and metadata are held exactly.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.kernels import ref as jref
from repro.kernels.grouped_expert import grouped_ffn as j_grouped_ffn
from repro.launch import serve as jserve
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.models import paged_cache as JPC
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.kernels import ops, ref
from repro_torch.kernels.grouped_expert import grouped_ffn
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.models import moe as TMOE
from repro_torch.models import paged_cache as PC
from test_torch_serve import _count_ops

ARCH = "granite-moe-1b-a400m"
FFN_TOL = 1e-5
MOE_TOL = 2e-5
TOL = 1e-4

# the five cases of tests/test_moe.py::test_grouped_ffn_tiers_match
GROUPED_CASES = [
    (4, 40, 64, 32, [10, 0, 25, 5]),     # ragged + an empty expert
    (3, 7, 16, 8, [7, 0, 0]),            # all tokens to one expert (first)
    (5, 33, 32, 16, [0, 0, 33, 0, 0]),   # all to one (middle), n % bn != 0
    (2, 129, 32, 48, [64, 65]),          # boundary straddles a row tile
    (4, 16, 16, 8, [4, 4, 4, 4]),        # exactly tile-aligned groups
]


def _dicts(tree):
    if isinstance(tree, dict):
        yield tree
        for v in tree.values():
            yield from _dicts(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _dicts(v)


def make_pair(seed=0, **overrides):
    """(jax cfg, jax params, port cfg, port params) of the reduced granite
    (2 layers, 4 experts, top-2, f32) with shared weights: the embedding
    scaled by 0.05 and norm scales randomised in numpy first, so the
    next-token distribution is not one-hot."""
    jcfg = JARCHS[ARCH].reduced(**overrides)
    tcfg = TARCHS[ARCH].reduced(**overrides)
    tree = jax.tree.map(np.array, JM.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    tree["embed"]["table"] *= 0.05
    for parent in _dicts(tree):
        if "scale" in parent:
            s = parent["scale"]
            parent["scale"] = (1 + rng.normal(0, 0.1, s.shape)).astype(s.dtype)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_jax(tree, tcfg,
                                                                         device="cpu")


@pytest.fixture(scope="module")
def pair():
    return make_pair(seed=5)


def _grouped_inputs(seed, e, n, d, f):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            *(rng.normal(0, 0.1, shape).astype(np.float32)
              for shape in ((e, d, f), (e, d, f), (e, f, d))))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ------------------------------------------------------- grouped expert FFN

@pytest.mark.parametrize("e,n,d,f,sizes", GROUPED_CASES)
def test_grouped_ffn_matches_jax_tiers(e, n, d, f, sizes):
    xs, wg, wi, wo = _grouped_inputs(n, e, n, d, f)
    gs = np.array(sizes, np.int32)
    got = ref.grouped_ffn_ref(*_t(xs, gs, wg, wi, wo)).numpy()
    # the kernel wrapper takes the plain version for CPU tensors, as does
    # the reference tier of ops
    np.testing.assert_array_equal(grouped_ffn(*_t(xs, gs, wg, wi, wo)).numpy(), got)
    np.testing.assert_array_equal(
        ops.grouped_ffn(*_t(xs, gs, wg, wi, wo), impl="reference").numpy(), got)
    jargs = [jnp.asarray(a) for a in (xs, gs, wg, wi, wo)]
    np.testing.assert_allclose(got, np.asarray(jref.grouped_ffn_ref(*jargs)), atol=FFN_TOL)
    kern = j_grouped_ffn(*jargs, block_rows=16, block_ff=8, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), atol=FFN_TOL)


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_grouped_ffn_zeroes_tail_rows_and_follows_act(act):
    """Group sizes summing to less than N: rows past the total are zeros,
    as in the JAX reference, for both activations."""
    xs, wg, wi, wo = _grouped_inputs(1, 3, 16, 8, 4)
    gs = np.array([5, 0, 6], np.int32)
    got = ref.grouped_ffn_ref(*_t(xs, gs, wg, wi, wo), act=act).numpy()
    want = jref.grouped_ffn_ref(*(jnp.asarray(a) for a in (xs, gs, wg, wi, wo)), act=act)
    np.testing.assert_allclose(got, np.asarray(want), atol=FFN_TOL)
    assert not got[11:].any() and np.abs(got[:11]).max() > 0


@pytest.mark.parametrize("e,n,d,f,sizes", GROUPED_CASES + [(4, 48, 8, 8, [0, 0, 0, 0]),
                                                           (3, 30, 8, 8, [5, 0, 6])])
def test_expert_ids_match_jax(e, n, d, f, sizes):
    """Per-row expert ids, rows past the total (and all rows when every
    group is empty) clamped to the last expert, as JAX's."""
    gs = np.array(sizes, np.int32)
    got = ref.expert_ids_of(torch.from_numpy(gs), n)
    assert got.dtype == torch.int32 and got.shape == (n,)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jref.expert_ids_of(jnp.asarray(gs), n)))


# ------------------------------------------------------------------ moe_apply

def _moe_params(seed, cfg):
    """JAX ``moe_init`` params of ``cfg``, as numpy, then in each package."""
    p = jax.tree.map(np.array, JMOE.moe_init(jax.random.PRNGKey(seed), cfg))
    return (jax.tree.map(jnp.asarray, p),
            jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p))


def test_moe_apply_matches_jax(pair):
    jcfg, _, tcfg, _ = pair
    jp, tp = _moe_params(0, jcfg)
    x = np.random.default_rng(1).standard_normal((2, 12, jcfg.d_model)).astype(np.float32)
    xf = x.reshape(-1, jcfg.d_model)
    _, _, j_top = JMOE._router(jp, jcfg, jnp.asarray(xf))
    _, t_top = TMOE._router(tp, tcfg, torch.from_numpy(xf))
    np.testing.assert_array_equal(t_top.numpy(), np.asarray(j_top))
    jy, _ = JMOE.moe_apply(jp, jcfg, jnp.asarray(x))
    ty = TMOE.moe_apply(tp, tcfg, torch.from_numpy(x), impl="reference")
    assert ty.dtype == torch.float32 and ty.shape == x.shape
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=MOE_TOL)


def test_moe_apply_casts_once_to_bf16():
    """bf16 rows and experts (fp32 router): the port's bf16 output is the
    fp32 combine cast once, as the JAX package's."""
    jcfg, jparams, tcfg, tparams = make_pair(seed=7, dtype="bfloat16")
    jp = jax.tree.map(lambda a: a[0], jparams["groups"][0]["b0"]["ffn"])
    tp = tparams["layers"][0]["ffn"]
    x = np.random.default_rng(2).standard_normal((1, 6, jcfg.d_model)).astype(np.float32)
    jy, _ = JMOE.moe_apply(jp, jcfg, jnp.asarray(x).astype(jnp.bfloat16))
    ty = TMOE.moe_apply(tp, tcfg, torch.from_numpy(x).to(torch.bfloat16),
                        impl="reference")
    assert ty.dtype == torch.bfloat16
    # the two fp32 sums may round to neighbouring bf16 values
    np.testing.assert_allclose(ty.float().numpy(), np.asarray(jy.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)


def test_dropless_is_cohort_independent(pair):
    """A token's MoE output agrees whether computed in a (2, 12) batch or
    alone in a (1, 1) decode-shaped cohort."""
    _, _, tcfg, _ = pair
    _, tp = _moe_params(2, pair[0])
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (2, 12, tcfg.d_model)).astype(np.float32))
    full = TMOE.moe_apply(tp, tcfg, x, impl="reference")
    for bi in range(2):
        for si in range(0, 12, 5):
            one = TMOE.moe_apply(tp, tcfg, x[bi:bi + 1, si:si + 1], impl="reference")
            np.testing.assert_allclose(one[0, 0].numpy(), full[bi, si].numpy(),
                                       atol=MOE_TOL)


# ------------------------------------------------------------ bridge, config

def test_bridge_carries_moe_leaves(pair):
    jcfg, jparams, tcfg, tparams = pair
    jffn = jparams["groups"][0]["b0"]["ffn"]
    for layer in range(tcfg.num_layers):
        ffn = tparams["layers"][layer]["ffn"]
        assert set(ffn) == {"router", "w_gate", "w_in", "w_out"}
        assert ffn["router"]["w"].dtype == torch.float32
        assert ffn["router"]["w"].shape == (tcfg.d_model, tcfg.n_experts)
        assert ffn["w_out"].shape == (tcfg.n_experts, tcfg.expert_d_ff, tcfg.d_model)
        for name in ("w_gate", "w_in", "w_out"):
            np.testing.assert_array_equal(ffn[name].numpy(),
                                          np.asarray(jffn[name][layer]))
        np.testing.assert_array_equal(ffn["router"]["w"].numpy(),
                                      np.asarray(jffn["router"]["w"][layer]))


def test_bridge_bf16_keeps_the_router_fp32():
    jcfg = JARCHS[ARCH].reduced(dtype="bfloat16")
    tree = jax.tree.map(np.array, JM.init_params(jax.random.PRNGKey(1), jcfg))
    tp = params_from_jax(tree, TARCHS[ARCH].reduced(dtype="bfloat16"), device="cpu")
    ffn = tp["layers"][1]["ffn"]
    assert ffn["router"]["w"].dtype == torch.float32
    assert ffn["w_gate"].dtype == torch.bfloat16
    want = np.asarray(tree["groups"][0]["b0"]["ffn"]["w_gate"][1], np.float32)
    np.testing.assert_array_equal(ffn["w_gate"].float().numpy(), want)


def test_config_and_init_match_jax():
    for tcfg, jcfg in ((TARCHS[ARCH], JARCHS[ARCH]),
                       (TARCHS[ARCH].reduced(), JARCHS[ARCH].reduced())):
        for f in dataclasses.fields(tcfg):
            if f.name not in ("superblock", "tail"):
                assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
        assert [(s.kind, s.window, s.has_ffn) for s in tcfg.layers] == [
            (s.kind, s.window, s.has_ffn) for s in jcfg.layers]
    tcfg = TARCHS[ARCH].reduced()
    p = TM.init_params(tcfg, seed=0, device="cpu")
    ffn = p["layers"][0]["ffn"]
    assert ffn["router"]["w"].dtype == torch.float32
    assert ffn["w_gate"].shape == (4, 64, 32) and ffn["w_out"].shape == (4, 32, 64)


# ------------------------------------------------------------------ the model

def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(1, vocab, (b, s)).astype(np.int32)


def test_forward_prefill_and_decode_logits_match_jax(pair):
    jcfg, jparams, tcfg, tparams = pair
    b, s, steps = 2, 12, 4
    toks = _tokens(1, b, s, jcfg.vocab_size)
    jh, _ = JM.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)}, remat=False)
    th = TM.forward(tparams, tcfg, {"tokens": torch.from_numpy(toks)}, impl="reference")
    np.testing.assert_allclose(TM.logits_of(tparams, tcfg, th).numpy(),
                               np.asarray(JM.logits_of(jparams, jcfg, jh)), atol=TOL, rtol=TOL)
    jlast, jc = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, s + steps)
    tlast, tc = TM.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks)}, s + steps,
                           impl="reference")
    np.testing.assert_allclose(TM.logits_of(tparams, tcfg, tlast[:, None]).numpy(),
                               np.asarray(JM.logits_of(jparams, jcfg, jlast[:, None])),
                               atol=TOL, rtol=TOL)
    feed = _tokens(2, b, steps, jcfg.vocab_size)
    for i in range(steps):
        jl, jc = JM.decode_step(jparams, jcfg, jnp.asarray(feed[:, i]), jc, s + i)
        tl, tc = TM.decode_step(tparams, tcfg, torch.from_numpy(feed[:, i]), tc, s + i,
                                impl="reference")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL,
                                   err_msg=f"step {i}")


def test_paged_decode_logits_match_jax(pair):
    """Prompts admitted through a shuffled table: paged decode logits equal
    the JAX dense ``decode_step``'s; then rows at ragged positions through
    ``paged_decode_and_sample_step`` on both sides, greedy."""
    jcfg, jparams, tcfg, tparams = pair
    bs, m, plen, steps = 8, 4, 16, 2
    rng = np.random.default_rng(4)
    toks = rng.integers(1, tcfg.vocab_size, (2, plen)).astype(np.int32)
    table = rng.permutation(np.arange(1, 1 + 2 * m)).reshape(2, m).astype(np.int32)
    slots, nb = np.arange(2, dtype=np.int32), PC.needed_blocks(plen, bs)
    _, jdense = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, plen + steps)
    _, jpre = JM.prefill(jparams, jcfg, {"tokens": jnp.asarray(toks)}, plen)
    jc = JPC.paged_cache_init(jcfg, 2, 1 + 2 * m, bs, 32, jcfg.dtype)
    jc = JPC.paged_insert(jcfg, jc, jpre, jnp.asarray(slots), jnp.asarray(table[:, :nb]),
                          plen)
    _, tdense = TM.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks)}, plen,
                           impl="reference")
    tc = PC.paged_cache_init(tcfg, 2, 1 + 2 * m, bs, 32, torch.float32, "cpu")
    PC.paged_insert(tcfg, tc, tdense, slots, table[:, :nb], plen, n_slots=2)
    tok = rng.integers(1, tcfg.vocab_size, 2).astype(np.int32)
    for i in range(steps):
        jl, jdense = JM.decode_step(jparams, jcfg, jnp.asarray(tok), jdense, plen + i)
        _, _, jc = JM.paged_decode_and_sample_step(  # the same writes to JAX's pool
            jparams, jcfg, jnp.asarray(tok), jc, jnp.asarray(table),
            jnp.full((2,), plen + i, jnp.int32), None)
        pos = torch.full((2,), plen + i, dtype=torch.int32)
        tl, tc = TM.paged_decode_step(tparams, tcfg, torch.from_numpy(tok), tc,
                                      torch.from_numpy(table), pos, impl="reference")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL)
        tok = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    jpos, tpos = jnp.asarray([18, 21], jnp.int32), torch.tensor([18, 21], dtype=torch.int32)
    jtok, ttok = jnp.asarray(tok), torch.from_numpy(tok)
    for _ in range(2):
        jtok, jlp, jc = JM.paged_decode_and_sample_step(
            jparams, jcfg, jtok, jc, jnp.asarray(table), jpos, None)
        ttok, tlp, tc = TM.paged_decode_and_sample_step(
            tparams, tcfg, ttok, tc, torch.from_numpy(table), tpos, impl="reference")
        np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
        np.testing.assert_allclose(tlp.numpy(), np.asarray(jlp), atol=TOL)
        jpos, tpos = jpos + 1, tpos + 1


def test_servers_greedy_match_jax(pair):
    """Greedy tokens of both engines are bit-identical to the JAX package's
    ``BatchServer`` and ``ContinuousBatchServer``; the continuous engine
    keeps the JAX schedule."""
    jcfg, jparams, tcfg, tparams = pair
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, tcfg.vocab_size, n).astype(np.int32) for n in (16, 16, 5, 16)]
    touts = tserve.BatchServer(tcfg, tparams, max_new=6, impl="reference").serve(prompts)
    jouts = jserve.BatchServer(jcfg, jparams, max_new=6).serve(prompts, None)
    for t, j in zip(touts, jouts):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    assert len({int(x) for t in touts for x in t}) > 3  # not degenerate
    full = [p for p in prompts if len(p) == 16]  # bucket-exact: no left padding
    new = [3, 8, 5]
    kw = dict(n_slots=2, kv_block_size=8, max_prompt=16, max_new=8)
    tsrv = tserve.ContinuousBatchServer(tcfg, tparams, impl="reference", **kw)
    jsrv = jserve.ContinuousBatchServer(jcfg, jparams, **kw)
    ttoks, tlps = tsrv.serve(full, max_new=new)
    jtoks, jlps = jsrv.serve(full, rng=None, max_new=new)
    for t, j, tl, jl in zip(ttoks, jtoks, tlps, jlps):
        np.testing.assert_array_equal(t, np.asarray(j))
        np.testing.assert_allclose(tl, np.asarray(jl), atol=TOL)
    keys = ("steps", "preemptions", "peak_blocks", "completion_order")
    assert {k: tsrv.stats()[k] for k in keys} == {k: jsrv.stats()[k] for k in keys}


def test_cuda_moe_raises_on_cpu(pair):
    _, _, tcfg, tparams = pair
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        TMOE.moe_apply(tparams["layers"][0]["ffn"], tcfg, torch.ones(1, 2, tcfg.d_model))


# ------------------------------------------------ chip_smoke rehearsal

@pytest.fixture(scope="module")
def chip_smoke():
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


def test_chip_smoke_granite_phases_on_cpu(chip_smoke, monkeypatch):
    """Phases 3 and 5 of granite at the reduced size on the reference tier:
    the router records one expert set per (token, layer), paged logits
    equal the dense decode's, and the ops calls that stand in for kernel
    launches equal the predicted launches of both engines, one
    grouped_ffn per layer per prefill and per decode step."""
    cfg = chip_smoke.get_config(ARCH).reduced()
    params = chip_smoke.make_params(cfg, seed=0, device="cpu")
    sl = chip_smoke.phase_slice(cfg, params, impl="reference", batch=2, prompt_len=20,
                                steps=3)
    assert sl["prefill_err"] == 0.0 and sl["route_agreement"] == 1.0 and sl["held_gap"] == 0.0
    pg = chip_smoke.phase_paged_slice(cfg, params, impl="reference", batch=2, prompt_len=20,
                                      steps=3, block_size=8)
    assert pg["paged_err"] < 1e-5 and pg["argmax_agreement"] == 1.0

    calls = _count_ops(monkeypatch)
    prompts, new = chip_smoke.continuous_traffic(cfg)
    runs = chip_smoke.phase_continuous(cfg, params, prompts, new, impl="reference",
                                       modes=("greedy", "sampled"))
    assert set(runs) == {"greedy", "sampled"}
    predicted = {k: sum(r["predicted"][k] for r in runs.values()) for k in calls}
    assert calls == predicted and predicted["flash_decode"] == 0
    for r in runs.values():
        assert r["predicted"]["grouped_ffn"] == cfg.num_layers * (r["admissions"]
                                                                 + 4 * r["steps"])
        assert [len(t) for t in r["outputs"]] == new
    for k in calls:
        calls[k] = 0
    bk = chip_smoke.bucketed_on(cfg, params, prompts, new, impl="reference")
    assert calls == bk["predicted"] and bk["predicted"]["grouped_ffn"] > 0
    assert not any(bk["launches"].values())  # no kernel ran on the reference tier
    for a, b in zip(runs["greedy"]["outputs"], bk["outputs"]):
        np.testing.assert_array_equal(a, b)
