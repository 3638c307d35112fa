"""The port's Mamba-2 SSD path against the JAX package: the chunked SSD scan
(plain version, the CPU path of the kernel wrapper and the reference tier
of ``ops``) against the JAX reference and the Pallas kernel in interpret
mode, the decode step, ``ssm_apply`` / ``ssm_decode_apply``, the bridge's
SSM leaves, the reduced mamba2-1.3b through every entry point, and greedy
serving through both engines on ragged traffic.

Inputs are made with numpy from a seed and handed to both packages; the
mixers' constant init leaves (A = -1, D = 1, dt_bias = 0 for every head)
are drawn at random first, so heads differ.  Tolerances: the scan's y and
state 1e-4 (fp32, ``tests/test_kernels.py::test_ssd_matches_ref``'s own);
the decode step and the modules 1e-5 (fp32, summation order only); logits
and logprobs 1e-4 (fp32 through the whole model, as
``test_torch_model.py``); greedy tokens, schedules and cache rows are held
exactly.
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
from repro.kernels.ssd_scan import ssd_pallas
from repro.launch import serve as jserve
from repro.models import model as JM
from repro.models import ssm as JSSM
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.models import paged_cache as PC
from repro_torch.models import ssm as TSSM

ARCH = "mamba2-1.3b"
SCAN_TOL = 1e-4
STEP_TOL = 1e-5
TOL = 1e-4

# the three cases of tests/test_kernels.py::test_ssd_matches_ref
SSD_CASES = [(2, 64, 3, 16, 8, 16), (1, 128, 2, 32, 16, 32), (1, 64, 1, 64, 128, 64)]


def _dicts(tree):
    if isinstance(tree, dict):
        yield tree
        for v in tree.values():
            yield from _dicts(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _dicts(v)


def randomize_mixers(tree, rng):
    """Draw the recurrent mixers' constant init leaves, in numpy, in place:
    A = -exp(a_log) in [-16, -1], dt = softplus(dt_bias) in [1e-3, 1e-1],
    D in [0.5, 1.5], conv biases at std 0.1, lam in [-2, 2], gate weights
    and biases at std 0.5."""
    def draw(name, a):
        if name == "a_log":
            return rng.uniform(0.0, np.log(16.0), a.shape)
        if name == "dt_bias":
            dt = np.exp(rng.uniform(np.log(1e-3), np.log(1e-1), a.shape))
            return dt + np.log(-np.expm1(-dt))
        if name == "d":
            return rng.uniform(0.5, 1.5, a.shape)
        if name == "lam":
            return rng.uniform(-2.0, 2.0, a.shape)
        if name == "conv_b":
            return rng.normal(0.0, 0.1, a.shape)
        if name.startswith("gate_"):
            return rng.normal(0.0, 0.5, a.shape)
        return None
    for parent in _dicts(tree):
        for name, a in list(parent.items()):
            if isinstance(a, np.ndarray):
                new = draw(name, a)
                if new is not None:
                    parent[name] = new.astype(a.dtype)


def make_pair(arch, seed=0, **overrides):
    """(jax cfg, jax params, port cfg, port params) of the reduced ``arch``
    (f32) with shared weights: the embedding scaled by 0.05, norm scales
    and the mixers' constant leaves randomised in numpy first."""
    jcfg = JARCHS[arch].reduced(**overrides)
    tcfg = TARCHS[arch].reduced(**overrides)
    tree = jax.tree.map(np.array, JM.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    tree["embed"]["table"] *= 0.05
    for parent in _dicts(tree):
        if "scale" in parent:
            s = parent["scale"]
            parent["scale"] = (1 + rng.normal(0, 0.1, s.shape)).astype(s.dtype)
    randomize_mixers(tree, rng)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_jax(tree, tcfg,
                                                                         device="cpu")


@pytest.fixture(scope="module")
def pair():
    return make_pair(ARCH, seed=3)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _ssd_inputs(seed, b, s, h, p, n):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h)))).astype(np.float32)
    a_log = (rng.standard_normal(h) * 0.5).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    d = rng.standard_normal(h).astype(np.float32)
    return x, dt, a_log, bm, cm, d


# ------------------------------------------------------------------ the scan

@pytest.mark.parametrize("b,s,h,p,n,chunk", SSD_CASES)
def test_ssd_ref_matches_jax_tiers(b, s, h, p, n, chunk):
    arrays = _ssd_inputs(s + h, b, s, h, p, n)
    y, st = ref.ssd_ref(*_t(*arrays), chunk=chunk, return_state=True)
    assert y.dtype == torch.float32 and st.shape == (b, h, p, n)
    # the kernel wrapper takes the plain version for CPU tensors, as does
    # the reference tier of ops
    wy, wst = ssd_scan(*_t(*arrays), chunk=chunk, return_state=True)
    oy, ost = ops.ssd(*_t(*arrays), chunk=chunk, return_state=True, impl="reference")
    for got in (wy, oy):
        np.testing.assert_array_equal(got.numpy(), y.numpy())
    for got in (wst, ost):
        np.testing.assert_array_equal(got.numpy(), st.numpy())
    jargs = [jnp.asarray(a) for a in arrays]
    jy, jst = jref.ssd_ref(*jargs, chunk=chunk, return_state=True)
    ky, kst = ssd_pallas(*jargs, chunk=chunk, return_state=True, interpret=True)
    for want_y, want_st in ((jy, jst), (ky, kst)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), atol=SCAN_TOL)
        np.testing.assert_allclose(st.numpy(), np.asarray(want_st), atol=SCAN_TOL)


def test_ssd_ref_takes_an_init_state_as_jax():
    """The reference tier carries a given state in (no caller passes one;
    the kernel tiers of both packages refuse it)."""
    arrays = _ssd_inputs(1, 2, 32, 2, 16, 8)
    init = np.random.default_rng(2).standard_normal((2, 2, 16, 8)).astype(np.float32)
    y, st = ref.ssd_ref(*_t(*arrays), chunk=16, init_state=torch.from_numpy(init),
                        return_state=True)
    jy, jst = jref.ssd_ref(*(jnp.asarray(a) for a in arrays), chunk=16,
                           init_state=jnp.asarray(init), return_state=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=SCAN_TOL)
    np.testing.assert_allclose(st.numpy(), np.asarray(jst), atol=SCAN_TOL)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ref.ssd_ref(*_t(*arrays), chunk=24)


def test_ssd_decode_ref_matches_jax_and_the_chunked_scan():
    """One step matches JAX's; stepping the whole sequence matches the
    chunked scan (y and the final state)."""
    b, s, h, p, n = 2, 24, 3, 8, 4
    x, dt, a_log, bm, cm, d = _ssd_inputs(4, b, s, h, p, n)
    state = np.random.default_rng(5).standard_normal((b, h, p, n)).astype(np.float32)
    y, new = ref.ssd_decode_ref(*_t(x[:, 0], dt[:, 0], a_log, bm[:, 0], cm[:, 0], d, state))
    jy, jnew = jref.ssd_decode_ref(*(jnp.asarray(a) for a in (
        x[:, 0], dt[:, 0], a_log, bm[:, 0], cm[:, 0], d, state)))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=STEP_TOL)
    np.testing.assert_allclose(new.numpy(), np.asarray(jnew), atol=STEP_TOL)
    tx, tdt, ta, tb, tc, td = _t(x, dt, a_log, bm, cm, d)
    st, ys = torch.zeros((b, h, p, n)), []
    for t in range(s):
        y_t, st = ops.ssd_decode(tx[:, t], tdt[:, t], ta, tb[:, t], tc[:, t], td, st)
        ys.append(y_t)
    y_chunk, st_chunk = ref.ssd_ref(tx, tdt, ta, tb, tc, td, chunk=8, return_state=True)
    np.testing.assert_allclose(torch.stack(ys, 1).numpy(), y_chunk.numpy(), atol=SCAN_TOL)
    np.testing.assert_allclose(st.numpy(), st_chunk.numpy(), atol=SCAN_TOL)


# ------------------------------------------------------------------ modules

@pytest.mark.parametrize("s", [13, 16])
def test_ssm_apply_and_decode_match_jax(pair, s):
    """``ssm_apply`` at an S that is (16) and is not (13) a multiple of the
    chunk (8), with its decode state; then 3 decode steps from it.  The
    port updates the state in place."""
    jcfg, jparams, tcfg, tparams = pair
    jp = jax.tree.map(lambda a: a[1], jparams["groups"][0]["b0"]["mixer"])
    tp = tparams["layers"][1]["mixer"]
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
    jy, jst = JSSM.ssm_apply(jp, jcfg, jnp.asarray(x), return_state=True)
    ty, tst = TSSM.ssm_apply(tp, tcfg, torch.from_numpy(x), impl="reference",
                             return_state=True)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=STEP_TOL)
    for name in ("ssm", "conv"):
        np.testing.assert_allclose(tst[name].numpy(), np.asarray(jst[name]), atol=STEP_TOL)
    assert tst["ssm"].dtype == torch.float32
    for i in range(3):
        xs = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
        jy, jst = JSSM.ssm_decode_apply(jp, jcfg, jnp.asarray(xs), jst)
        ty = TSSM.ssm_decode_apply(tp, tcfg, torch.from_numpy(xs), tst)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=STEP_TOL, err_msg=str(i))
        for name in ("ssm", "conv"):
            np.testing.assert_allclose(tst[name].numpy(), np.asarray(jst[name]),
                                       atol=STEP_TOL)


def test_ssm_apply_short_prompt_pads_the_conv_state(pair):
    """S = 2 < K - 1: the conv state is left-padded with zeros, as JAX's."""
    jcfg, jparams, tcfg, tparams = pair
    jp = jax.tree.map(lambda a: a[0], jparams["groups"][0]["b0"]["mixer"])
    x = np.random.default_rng(9).standard_normal((1, 2, jcfg.d_model)).astype(np.float32)
    _, jst = JSSM.ssm_apply(jp, jcfg, jnp.asarray(x), return_state=True)
    _, tst = TSSM.ssm_apply(tparams["layers"][0]["mixer"], tcfg, torch.from_numpy(x),
                            impl="reference", return_state=True)
    assert tst["conv"].shape == (1, 3, tcfg.ssm_inner + 2 * tcfg.ssm_state)
    assert not tst["conv"][:, 0].any()
    np.testing.assert_allclose(tst["conv"].numpy(), np.asarray(jst["conv"]), atol=STEP_TOL)


# ------------------------------------------------------------ bridge, config

def test_config_matches_jax():
    for tcfg, jcfg in ((TARCHS[ARCH], JARCHS[ARCH]),
                       (TARCHS[ARCH].reduced(), JARCHS[ARCH].reduced())):
        for f in dataclasses.fields(tcfg):
            if f.name not in ("superblock", "tail"):
                assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
        assert (tcfg.ssm_inner, tcfg.ssm_heads) == (jcfg.ssm_inner, jcfg.ssm_heads)
        assert [(s.kind, s.window, s.has_ffn) for s in tcfg.layers] == [
            (s.kind, s.window, s.has_ffn) for s in jcfg.layers]
    full = TARCHS[ARCH]
    assert (full.ssm_inner, full.ssm_heads, full.num_layers) == (4096, 64, 48)


def test_bridge_bf16_keeps_the_ssm_scalars_fp32():
    jcfg = JARCHS[ARCH].reduced(dtype="bfloat16")
    tree = jax.tree.map(np.array, JM.init_params(jax.random.PRNGKey(1), jcfg))
    tp = params_from_jax(tree, TARCHS[ARCH].reduced(dtype="bfloat16"), device="cpu")
    m = tp["layers"][1]["mixer"]
    assert set(m) == {"in_proj", "conv_w", "conv_b", "a_log", "d", "dt_bias", "norm",
                      "out_proj"}
    for name in ("a_log", "d", "dt_bias"):
        assert m[name].dtype == torch.float32
    assert m["conv_w"].dtype == m["in_proj"]["w"].dtype == torch.bfloat16
    want = np.asarray(tree["groups"][0]["b0"]["mixer"]["conv_w"][1], np.float32)
    np.testing.assert_array_equal(m["conv_w"].float().numpy(), want)


def test_init_params_builds_the_ssm_stack():
    tcfg = TARCHS[ARCH].reduced()
    p = TM.init_params(tcfg, seed=0, device="cpu")
    m = p["layers"][0]["mixer"]
    assert m["in_proj"]["w"].shape == (64, 2 * 128 + 2 * 16 + 8)
    assert m["conv_w"].shape == (4, 128 + 2 * 16)
    assert "ffn" not in p["layers"][0]  # ffn_kind "none"
    assert torch.equal(m["a_log"], torch.zeros(8)) and torch.equal(m["d"], torch.ones(8))


# ------------------------------------------------------------------ the model

def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(1, vocab, (b, s)).astype(np.int32)


def check_model_against_jax(pair, *, b=2, s=13, steps=8, seed=1):
    """Forward and prefill logits, ``steps`` teacher-forced decode steps,
    greedy ``generate`` tokens and logprobs of the port against JAX's."""
    jcfg, jparams, tcfg, tparams = pair
    toks = _tokens(seed, b, s, jcfg.vocab_size)
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
    feed = _tokens(seed + 1, b, steps, jcfg.vocab_size)
    for i in range(steps):
        jl, jc = JM.decode_step(jparams, jcfg, jnp.asarray(feed[:, i]), jc, s + i)
        tl, tc = TM.decode_step(tparams, tcfg, torch.from_numpy(feed[:, i]), tc, s + i,
                                impl="reference")
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=TOL, rtol=TOL,
                                   err_msg=f"step {i}")
    jout = JM.generate(jparams, jcfg, {"tokens": jnp.asarray(toks)}, num_new_tokens=6)
    tout = TM.generate(tparams, tcfg, {"tokens": torch.from_numpy(toks)}, num_new_tokens=6,
                       impl="reference")
    np.testing.assert_array_equal(tout["tokens"].numpy(), np.asarray(jout["tokens"]))
    np.testing.assert_allclose(tout["logprobs"].numpy(), np.asarray(jout["logprobs"]),
                               atol=TOL)
    assert len(set(tout["tokens"].reshape(-1).tolist())) > 2  # not degenerate


def test_model_logits_decode_and_generate_match_jax(pair):
    check_model_against_jax(pair)


def check_servers_against_jax(pair, seed=6):
    """Greedy tokens of both engines on ragged traffic (left-padded inside
    a bucket, pads run through the recurrence) equal the JAX package's,
    and the continuous engine keeps the JAX schedule."""
    jcfg, jparams, tcfg, tparams = pair
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(1, tcfg.vocab_size, n).astype(np.int32) for n in (16, 5, 11, 3)]
    touts = tserve.BatchServer(tcfg, tparams, max_new=6, impl="reference").serve(prompts)
    jouts = jserve.BatchServer(jcfg, jparams, max_new=6).serve(prompts, None)
    for t, j in zip(touts, jouts):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    new = [3, 8, 5, 6]
    kw = dict(n_slots=2, kv_block_size=8, max_prompt=16, max_new=8)
    tsrv = tserve.ContinuousBatchServer(tcfg, tparams, impl="reference", **kw)
    jsrv = jserve.ContinuousBatchServer(jcfg, jparams, **kw)
    ttoks, tlps = tsrv.serve(prompts, max_new=new)
    jtoks, jlps = jsrv.serve(prompts, rng=None, max_new=new)
    for t, j, tl, jl in zip(ttoks, jtoks, tlps, jlps):
        np.testing.assert_array_equal(t, np.asarray(j))
        np.testing.assert_allclose(tl, np.asarray(jl), atol=TOL)
    keys = ("steps", "preemptions", "peak_blocks", "completion_order")
    assert {k: tsrv.stats()[k] for k in keys} == {k: jsrv.stats()[k] for k in keys}
    return tsrv


def test_servers_greedy_match_jax_on_ragged_traffic(pair):
    tsrv = check_servers_against_jax(pair)
    assert tsrv.kv_peak_bytes() == 0  # no full-attention layer holds a pool


def check_paged_insert_rows(pair, seed=7):
    """``paged_insert`` copies each admitted row's recurrent state (and a
    ring's rows) into its slot, bit for bit from the dense prefill, writes
    no padding row, and leaves other slots alone."""
    _, _, tcfg, tparams = pair
    toks = _tokens(seed, 4, 9, tcfg.vocab_size)
    _, dense = TM.prefill(tparams, tcfg, {"tokens": torch.from_numpy(toks)}, 9,
                          impl="reference")
    n_slots = 5
    caches = PC.paged_cache_init(tcfg, n_slots, 7, 8, 24, torch.float32, "cpu")
    for c in caches:
        for t in c.values():
            t.fill_(7.0)
    slots = np.array([3, 0, n_slots, 1])  # row 2 is a padding row
    table = np.array([[1, 2], [3, 4], [0, 0], [5, 6]])
    PC.paged_insert(tcfg, caches, dense, slots, table, 9, n_slots=n_slots)
    for spec, c, d in zip(tcfg.layers, caches, dense):
        if spec.kind == "attn" and spec.window is None:
            continue
        for name in c:
            for row, slot in ((0, 3), (1, 0), (3, 1)):
                cap = d[name].shape[1] if spec.kind == "attn" else None
                np.testing.assert_array_equal(c[name][slot, :cap].numpy(),
                                              d[name][row].numpy())
            assert bool((c[name][[2, 4]] == 7.0).all())  # untouched slots
    return caches


def test_paged_insert_copies_state_rows(pair):
    caches = check_paged_insert_rows(pair)
    assert all(set(c) == {"ssm", "conv"} for c in caches)
    assert PC.kv_pool_bytes(pair[2], 100, 16) == 0
    assert PC.full_buffer_bytes(pair[2], 8, 64) == 0


def test_cuda_tier_raises_on_cpu(pair):
    _, _, tcfg, tparams = pair
    x = torch.ones(1, 8, tcfg.d_model)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        TSSM.ssm_apply(tparams["layers"][0]["mixer"], tcfg, x)
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        TM.generate(tparams, tcfg, {"tokens": torch.ones((1, 4), dtype=torch.int64)},
                    num_new_tokens=2)


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


def count_ops(monkeypatch):
    """Count the ops calls that stand in for kernel launches on the
    reference tier, the scans included."""
    calls = {"flash_mha": 0, "flash_decode": 0, "paged_flash_decode": 0, "grouped_ffn": 0,
             "ssd_scan": 0, "rglru_scan": 0}

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    for op, name in (("mha", "flash_mha"), ("decode_mha", "flash_decode"),
                     ("paged_decode_mha", "paged_flash_decode"),
                     ("grouped_ffn", "grouped_ffn"), ("ssd", "ssd_scan"),
                     ("rglru_scan", "rglru_scan")):
        monkeypatch.setattr(ops, op, count(name, getattr(ops, op)))
    return calls


def rehearse_chip_smoke(chip_smoke, monkeypatch, arch):
    """Phases 3 and 5 of ``arch`` at the reduced size on the reference
    tier: paged decode logits equal the dense decode's exactly (a
    recurrent layer steps the same state either way), and the ops calls
    that stand in for kernel launches equal the predicted launches of
    both engines.  Returns the continuous runs' predictions."""
    cfg = chip_smoke.get_config(arch).reduced()
    params = chip_smoke.make_params(cfg, seed=0, device="cpu")
    sl = chip_smoke.phase_slice(cfg, params, impl="reference", batch=2, prompt_len=20,
                                steps=3)
    assert sl["prefill_err"] == 0.0 and sl["route_agreement"] is None
    pg = chip_smoke.phase_paged_slice(cfg, params, impl="reference", batch=2, prompt_len=20,
                                      steps=3, block_size=8)
    assert pg["paged_err"] == 0.0 and pg["argmax_agreement"] == 1.0

    calls = count_ops(monkeypatch)
    prompts, new = chip_smoke.continuous_traffic(cfg)
    runs = chip_smoke.phase_continuous(cfg, params, prompts, new, impl="reference",
                                       modes=("greedy", "sampled"))
    predicted = {k: sum(r["predicted"].get(k, 0) for r in runs.values()) for k in calls}
    assert calls == predicted
    for r in runs.values():
        assert [len(t) for t in r["outputs"]] == new
        assert not any(r["launches"].values())  # no kernel ran on the reference tier
    for k in calls:
        calls[k] = 0
    bk = chip_smoke.bucketed_on(cfg, params, prompts, new, impl="reference")
    assert chip_smoke.same_launches(calls, bk["predicted"])
    for a, b in zip(runs["greedy"]["outputs"], bk["outputs"]):
        np.testing.assert_array_equal(a, b)
    return {k: [r["predicted"].get(k, 0) for r in runs.values()] for k in calls}, runs


def test_chip_smoke_mamba2_phases_on_cpu(chip_smoke, monkeypatch):
    predicted, runs = rehearse_chip_smoke(chip_smoke, monkeypatch, ARCH)
    cfg = chip_smoke.get_config(ARCH).reduced()
    assert predicted["flash_mha"] == predicted["flash_decode"] == [0, 0]
    assert predicted["paged_flash_decode"] == predicted["rglru_scan"] == [0, 0]
    assert predicted["ssd_scan"] == [cfg.num_layers * r["admissions"] for r in runs.values()]
    assert all(r["kv_peak_bytes"] == 0 for r in runs.values())


def test_chip_smoke_randomizes_the_mixer_leaves(chip_smoke):
    cfg = chip_smoke.get_config(ARCH).reduced()
    m = chip_smoke.make_params(cfg, seed=0, device="cpu")["layers"][1]["mixer"]
    a = -torch.exp(m["a_log"])
    dt = torch.nn.functional.softplus(m["dt_bias"])
    assert bool(((a >= -16) & (a <= -1)).all()) and a.unique().numel() == a.numel()
    assert bool(((dt > 0.99e-3) & (dt < 1.01e-1)).all())
    assert bool(((m["d"] >= 0.5) & (m["d"] <= 1.5)).all()) and m["conv_b"].abs().max() > 0
