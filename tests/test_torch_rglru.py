"""The port's RG-LRU path and recurrentgemma-9b against the JAX package: the
RG-LRU scan (plain version, the CPU path of the kernel wrapper and the
reference tier of ``ops``) against the JAX reference and the Pallas kernel
in interpret mode, the gates, ``lru_apply`` / ``lru_decode_apply``, the
attention plain versions at recurrentgemma's head_dim 256, the bridge's
RG-LRU leaves and tail group, the reduced recurrentgemma-9b through every
entry point, and greedy serving through both engines on ragged traffic.

Inputs are made with numpy from a seed and handed to both packages; the
mixers' constant init leaves (zero gates, lam = -1) are drawn at random
first (``test_torch_ssm.make_pair``).  Tolerances: the scan's h and final
state 1e-5 (fp32, ``tests/test_kernels.py::test_rglru_matches_ref``'s
own); the gates and modules 1e-5 (fp32, summation order only); attention
2e-6 absolute and relative (fp32, ``test_flash_mha_matches_ref``'s own); logits and logprobs 1e-4 (fp32 through the whole model); greedy
tokens, schedules and cache rows are held exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.kernels import ref as jref
from repro.kernels.rglru_scan import rglru_pallas
from repro.models import model as JM
from repro.models import rglru as JR
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import flash_decode
from repro_torch.kernels.flash_attention import flash_mha
from repro_torch.kernels.rglru_scan import rglru_scan
from repro_torch.models import model as TM
from repro_torch.models import rglru as TR
from test_torch_ssm import (chip_smoke, check_model_against_jax,  # noqa: F401
                            check_paged_insert_rows, check_servers_against_jax, make_pair,
                            rehearse_chip_smoke)

ARCH = "recurrentgemma-9b"
SCAN_TOL = 1e-5
STEP_TOL = 1e-5
ATTN_TOL = 2e-6


@pytest.fixture(scope="module")
def pair():
    return make_pair(ARCH, seed=4)


def _scan_inputs(seed, b, s, w):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.0, 1.0, (b, s, w)).astype(np.float32)
    bx = rng.standard_normal((b, s, w)).astype(np.float32)
    return a, bx


# ------------------------------------------------------------------ the scan

@pytest.mark.parametrize("s", [17, 33, 100])
@pytest.mark.parametrize("w", [32, 64])
def test_rglru_scan_ref_matches_jax_tiers(s, w):
    a, bx = _scan_inputs(s * w, 2, s, w)
    h, final = ref.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(bx))
    assert h.dtype == final.dtype == torch.float32 and final.shape == (2, w)
    # the kernel wrapper takes the plain version for CPU tensors, as does
    # the reference tier of ops
    for got in (rglru_scan(torch.from_numpy(a), torch.from_numpy(bx)),
                ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(bx), impl="reference")):
        np.testing.assert_array_equal(got[0].numpy(), h.numpy())
        np.testing.assert_array_equal(got[1].numpy(), final.numpy())
    ja, jbx = jnp.asarray(a), jnp.asarray(bx)
    for jh, jfinal in (jref.rglru_scan_ref(ja, jbx),
                       rglru_pallas(ja, jbx, chunk=32, block_w=64, interpret=True)):
        np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=SCAN_TOL)
        np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), atol=SCAN_TOL)


def test_rglru_scan_ref_init_state_and_dtype_follow_jax():
    """The reference tier carries a given state in (the kernel tiers of both
    packages refuse one); h keeps bx's dtype while the final state is fp32;
    S = 1 needs no doubling round."""
    a, bx = _scan_inputs(3, 2, 9, 16)
    init = np.random.default_rng(4).standard_normal((2, 16)).astype(np.float32)
    h, final = ref.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(bx),
                                  torch.from_numpy(init))
    jh, jfinal = jref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(bx), jnp.asarray(init))
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=SCAN_TOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), atol=SCAN_TOL)
    hb, fb = ref.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(bx).to(torch.bfloat16))
    assert hb.dtype == torch.bfloat16 and fb.dtype == torch.float32
    h1, f1 = ref.rglru_scan_ref(torch.from_numpy(a[:, :1]), torch.from_numpy(bx[:, :1]))
    np.testing.assert_array_equal(h1[:, 0].numpy(), bx[:, 0])
    np.testing.assert_array_equal(f1.numpy(), bx[:, 0])


def test_rglru_scan_equals_the_decode_recurrence():
    a, bx = _scan_inputs(5, 3, 40, 8)
    h, final = ref.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(bx))
    carry = np.zeros((3, 8), np.float32)
    for t in range(40):
        carry = a[:, t] * carry + bx[:, t]
        np.testing.assert_allclose(h[:, t].numpy(), carry, atol=SCAN_TOL)
    np.testing.assert_allclose(final.numpy(), carry, atol=SCAN_TOL)


# ------------------------------------------------------------------ modules

def test_gates_match_jax(pair):
    jcfg, jparams, _, tparams = pair
    jp = jax.tree.map(lambda a: a[0], jparams["groups"][0]["b1"]["mixer"])
    tp = tparams["layers"][1]["mixer"]
    u = np.random.default_rng(2).standard_normal((2, 7, jcfg.lru_width)).astype(np.float32) * 3
    ja, jbx = JR._gates(jp, jnp.asarray(u))
    ta, tbx = TR._gates(tp, torch.from_numpy(u))
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=STEP_TOL)
    np.testing.assert_allclose(tbx.numpy(), np.asarray(jbx), atol=STEP_TOL)
    assert float(ta.min()) < 0.5 < float(ta.max()) <= 1.0  # gates vary by channel


@pytest.mark.parametrize("s", [2, 13])
def test_lru_apply_and_decode_match_jax(pair, s):
    """``lru_apply`` with its decode state (S = 2 < K - 1 pads the conv
    state), then 3 decode steps from it; the tail group's layer too.  The
    port updates the state in place."""
    jcfg, jparams, tcfg, tparams = pair
    # layer 3 is the second repeat's first block, layer 7 the tail's second
    for jgroup, rep, layer in ((jparams["groups"][0]["b0"], 1, 3),
                               (jparams["groups"][1]["b1"], 0, 7)):
        jp = jax.tree.map(lambda a, r=rep: a[r], jgroup["mixer"])
        tp = tparams["layers"][layer]["mixer"]
        rng = np.random.default_rng(s + layer)
        x = rng.standard_normal((2, s, jcfg.d_model)).astype(np.float32)
        jy, jst = JR.lru_apply(jp, jcfg, jnp.asarray(x), return_state=True)
        ty, tst = TR.lru_apply(tp, tcfg, torch.from_numpy(x), impl="reference",
                               return_state=True)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=STEP_TOL)
        for name in ("h", "conv"):
            np.testing.assert_allclose(tst[name].numpy(), np.asarray(jst[name]),
                                       atol=STEP_TOL)
        for i in range(3):
            xs = rng.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
            jy, jst = JR.lru_decode_apply(jp, jcfg, jnp.asarray(xs), jst)
            ty = TR.lru_decode_apply(tp, tcfg, torch.from_numpy(xs), tst)
            np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=STEP_TOL,
                                       err_msg=f"layer {layer} step {i}")
            for name in ("h", "conv"):
                np.testing.assert_allclose(tst[name].numpy(), np.asarray(jst[name]),
                                           atol=STEP_TOL)


def test_attention_plain_versions_at_head_dim_256():
    """recurrentgemma-9b's attention shapes (16 query heads on 1 KV head,
    D 256): prefill with a window shorter than S, decode over a ring with a
    row of length 0, through the kernel wrappers' CPU path."""
    rng = np.random.default_rng(11)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((2, 40, 16, 256), (2, 40, 1, 256), (2, 40, 1, 256)))
    got = flash_mha(*(torch.from_numpy(t) for t in (q, k, v)), causal=True, window=16)
    want = jref.mha_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
                        window=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL,
                               rtol=ATTN_TOL)
    lens = np.array([0, 37], np.int32)
    got = flash_decode(torch.from_numpy(q[:, 0]), torch.from_numpy(k[:, :16]),
                       torch.from_numpy(v[:, :16]), cache_len=torch.from_numpy(lens),
                       window=16)
    want = jref.decode_mha_ref(jnp.asarray(q[:, 0]), jnp.asarray(k[:, :16]),
                               jnp.asarray(v[:, :16]), cache_len=jnp.asarray(lens), window=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATTN_TOL,
                               rtol=ATTN_TOL)


# ------------------------------------------------------------ bridge, config

def test_config_matches_jax():
    for tcfg, jcfg in ((TARCHS[ARCH], JARCHS[ARCH]),
                       (TARCHS[ARCH].reduced(), JARCHS[ARCH].reduced())):
        for f in dataclasses.fields(tcfg):
            if f.name not in ("superblock", "tail"):
                assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
        assert [(s.kind, s.window, s.has_ffn) for s in tcfg.layers] == [
            (s.kind, s.window, s.has_ffn) for s in jcfg.layers]
    kinds = [s.kind for s in TARCHS[ARCH].layers]
    assert (kinds.count("lru"), kinds.count("attn"), TARCHS[ARCH].head_dim) == (26, 12, 256)


def test_bridge_carries_the_tail_group_and_fp32_gates():
    jcfg = JARCHS[ARCH].reduced(dtype="bfloat16")
    tcfg = TARCHS[ARCH].reduced(dtype="bfloat16")
    tree = jax.tree.map(np.array, JM.init_params(jax.random.PRNGKey(1), jcfg))
    tp = params_from_jax(tree, tcfg, device="cpu")
    assert len(tp["layers"]) == tcfg.num_layers == 8
    assert [set(p["mixer"]) >= {"lam"} for p in tp["layers"]] == [
        s.kind == "lru" for s in tcfg.layers]
    tail = tp["layers"][7]["mixer"]
    for name in ("gate_a_w", "gate_a_b", "gate_x_w", "gate_x_b", "lam"):
        assert tail[name].dtype == torch.float32
    assert tail["w_in"]["w"].dtype == tail["conv_w"].dtype == torch.bfloat16
    want = np.asarray(tree["groups"][1]["b1"]["mixer"]["w_in"]["w"][0], np.float32)
    np.testing.assert_array_equal(tail["w_in"]["w"].float().numpy(), want)
    assert tp["layers"][2]["ffn"]["w_gate"]["w"].shape == (64, 128)


def test_init_params_builds_the_hybrid_stack():
    tcfg = TARCHS[ARCH].reduced()
    p = TM.init_params(tcfg, seed=0, device="cpu")
    assert set(p["layers"][2]["mixer"]) == {"wq", "wk", "wv", "wo"}
    m = p["layers"][0]["mixer"]
    assert m["conv_w"].shape == (4, 64) and torch.equal(m["lam"], torch.full((64,), -1.0))


# ------------------------------------------------------------------ the model

def test_model_logits_decode_and_generate_match_jax(pair):
    """Prompt 13 + 8 decode steps: the reduced window of 16 wraps its ring."""
    check_model_against_jax(pair)


def test_servers_greedy_match_jax_on_ragged_traffic(pair):
    check_servers_against_jax(pair)


def test_paged_insert_copies_state_and_ring_rows(pair):
    caches = check_paged_insert_rows(pair)
    assert [set(c) for c in caches] == [{"k", "v"} if s.kind == "attn" else {"h", "conv"}
                                        for s in pair[2].layers]


def test_cuda_tier_raises_on_cpu(pair):
    _, _, tcfg, tparams = pair
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        TR.lru_apply(tparams["layers"][0]["mixer"], tcfg, torch.ones(1, 8, tcfg.d_model))
    with pytest.raises(ValueError, match="impl='cuda' needs CUDA tensors"):
        ops.rglru_scan(torch.ones(1, 4, 8), torch.ones(1, 4, 8))


# ------------------------------------------------ chip_smoke rehearsal

def test_chip_smoke_recurrentgemma_phases_on_cpu(chip_smoke, monkeypatch):  # noqa: F811
    predicted, runs = rehearse_chip_smoke(chip_smoke, monkeypatch, ARCH)
    cfg = chip_smoke.get_config(ARCH).reduced()
    kinds = [s.kind for s in cfg.layers]
    n_lru, n_attn = kinds.count("lru"), kinds.count("attn")
    assert predicted["paged_flash_decode"] == predicted["ssd_scan"] == [0, 0]
    for name, per in (("rglru_scan", n_lru), ("flash_mha", n_attn)):
        assert predicted[name] == [per * r["admissions"] for r in runs.values()]
    assert predicted["flash_decode"] == [n_attn * 4 * r["steps"] for r in runs.values()]
    assert min(predicted["flash_decode"]) > 0
