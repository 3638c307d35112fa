"""``chip_smoke.py``'s phase 14 rehearsed on the CPU at the reduced size
with ``impl="reference"``, in fp32, on arctic-480b: (a) layer 0's FFN
under both dispatches against a plain transcription of Arctic's FFN, the
tiers with their route agreement and the paged decode; (c) the capacity
dispatch at a shape that overflows (the hidden states given a common
direction and layer 0's router column 0 aligned with it, so almost every
token picks expert 0) and on cohorts within its floor; (d) the gradient
tiers with the parameters taking requires_grad in place; (e) the experts
and the dense residual over 4 ranks; the launch predictions and phase 14's
sizes at full width.  Planted faults show that the checks catch what they
are for: the dense residual left out, a capacity dispatch that drops
nothing, an expert-parallel layer without the dense residual.
"""

import os
import sys

import pytest
import torch

from repro_torch.models import moe as TMOE

ROOT = os.path.join(os.path.dirname(__file__), "..")
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def cs():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    return chip_smoke


def model(cs, seed=0, **kw):
    cfg = cs.get_config(cs.ARCTIC).reduced(**kw)
    return cfg, cs.make_dense_params(cfg, seed=seed, device=CPU)


def overflowing(cfg, params):
    """Add a common unit vector u to every embedding and set layer 0's
    router column 0 to 4 u: almost every token routes to expert 0 there,
    past its capacity."""
    u = torch.nn.functional.normalize(
        torch.randn(cfg.d_model, generator=torch.Generator().manual_seed(9)), dim=0)
    with torch.no_grad():
        params["embed"]["table"] += u
        params["layers"][0]["ffn"]["router"]["w"][:, 0] = 4 * u


def _no_dense(p):
    return {k: v for k, v in p.items() if k != "dense"}


# ------------------------------------------------------------------ 14a

def test_phase14a_layer_tiers_and_paged_decode(cs, monkeypatch):
    cfg, params = model(cs)
    errs = cs.arctic_layer_check(cfg, params, impl="reference")
    assert set(errs) == {"dropless", "capacity"} and max(errs.values()) <= 1e-5
    sl = cs.phase_slice(cfg, params, impl="reference", batch=2, prompt_len=16, steps=3)
    assert sl["prefill_err"] == sl["decode_err"] == sl["agreed_err"] == 0
    assert (sl["parted"], sl["entries"], sl["route_agreement"], sl["held_gap"]) == (
        0, 2 * 4, 1.0, 0.0)
    pg = cs.phase_paged_slice(cfg, params, impl="reference", batch=2, prompt_len=16, steps=3)
    assert pg["paged_err"] <= 1e-5
    apply = TMOE.moe_apply
    monkeypatch.setattr(TMOE, "moe_apply", lambda p, c, x, **kw: apply(_no_dense(p), c, x, **kw))
    fault = cs.arctic_layer_check(cfg, params, impl="reference")
    assert min(fault.values()) > cs.KERNEL_TOL


# ------------------------------------------------------------------ 14c

def test_phase14c_capacity_dispatch(cs, monkeypatch):
    cfg, params = model(cs)
    overflowing(cfg, params)
    r = cs.phase_capacity(cfg, params, impl="reference", batch=4, prompt_len=64, steps=3)
    assert r["assignments"] == cfg.num_layers * 4 * 64 * cfg.top_k
    assert r["drop_share"] > 0.05 and r["small"]["dropped"] == 0
    assert r["prefill_err"] == r["decode_err"] == r["agreed_err"] == 0 and r["parted"] == 0
    small = r["small"]
    assert small["parted"] == 0 and small["held_gap"] == 0
    assert max(small["prefill_err"], small["decode_err"]) <= 1e-5
    assert r["launches"]["grouped_ffn"] == 0  # the reference tier launches nothing at all
    monkeypatch.setattr(TMOE, "capacity", lambda n_tokens, c: n_tokens)
    fault = cs.phase_capacity(cfg, params, impl="reference", batch=4, prompt_len=64, steps=3)
    assert fault["drop_share"] == 0


# ------------------------------------------------------------------ 14d

def test_phase14d_gradient_tiers_in_place(cs):
    cfg, params = model(cs)
    del params["layers"][1:]
    cfg = cs.shallow(cfg, 1)
    assert cfg.num_layers == 1
    batch = cs.lm_batch(cfg, CPU, batch=2, prompt=8, new=8)
    parted, held_gap = cs.parted_tokens(cfg, params, batch["tokens"], impl="reference")
    assert parted.shape == batch["tokens"].shape and not parted.any() and held_gap == 0
    r = cs.grad_tiers_in_place(cfg, params, batch, impl="reference")
    assert r["finite"] and r["loss_err"] == r["global_err"] == r["worst_leaf_err"] == 0
    assert r["n_leaves"] == len(cs.adamw.leaves(params)) and r["aux_loss"] > 0
    assert all(not t.requires_grad and t.grad is None for t in cs.adamw.leaves(params))
    big = torch.zeros(4, 1 << 23)  # two slices of 2^24 elements
    assert cs.all_finite(big) and cs.all_finite(torch.tensor(1.0))
    big[3, 7] = float("nan")
    assert not cs.all_finite(big)


# ------------------------------------------------------------------ 14e

def test_phase14e_experts_and_dense_residual_over_ranks(cs, monkeypatch):
    cfg, params = model(cs, n_kv_heads=4)
    del params["layers"][1:]
    cfg = cs.shallow(cfg, 1)
    r = cs.phase_ep(cfg, params, cs.ARCTIC_EP, impl="reference", batch=2, prompt_len=16)
    assert r["err"] <= 1e-5 and r["ranks_route_alike"] and r["routes"]["agreement"] == 1.0
    assert r["parted"] == 0 and r["agree_err"] == r["err"] and r["tokens"] == 2 * 16
    assert r["held_gap"] == 0
    sharded = TMOE.moe_apply_sharded
    monkeypatch.setattr(TMOE, "moe_apply_sharded", lambda ps, c, xs, **kw: sharded(
        {k: _no_dense(p) for k, p in ps.items()}, c, xs, **kw))
    fault = cs.phase_ep(cfg, params, cs.ARCTIC_EP, impl="reference", batch=2, prompt_len=16)
    assert fault["agree_err"] > cs.LOGIT_TOL


def _second_run_on(cs, monkeypatch, params):
    """Make ``compare_routed``'s second run take ``params``."""
    calls = []
    real = cs.routed_logits

    def mixed(c, p, *a, **kw):
        calls.append(1)
        return real(c, p if len(calls) == 1 else params, *a, **kw)
    monkeypatch.setattr(cs, "routed_logits", mixed)


def _router_column_scaled(params, layer, factor):
    return {**params, "layers": [
        dict(p, ffn=dict(p["ffn"], router={"w": p["ffn"]["router"]["w"] * torch.cat(
            [torch.full((1,), factor), torch.ones(p["ffn"]["router"]["w"].shape[1] - 1)])}))
        if i == layer else p for i, p in enumerate(params["layers"])]}


def test_phase14_routed_comparison_counts_parted_tokens(cs, monkeypatch):
    """``compare_routed`` of two runs whose routes part (the second with
    every router column but the first negated): the parted tokens are
    counted and left out, the error over all of them is not, and the
    first partings' gap is far past a near-tie."""
    cfg, params = model(cs)
    toks, feed = cs.slice_tokens(cfg, params, 2, 12, 2, 0)
    flipped = {**params, "layers": [dict(p, ffn=dict(p["ffn"], router={"w": torch.cat(
        [p["ffn"]["router"]["w"][:, :1], -p["ffn"]["router"]["w"][:, 1:]], 1)}))
        for p in params["layers"]]}
    r = cs.compare_routed(params, toks, feed, (cfg, "reference"), (cfg, "reference"))
    assert r["parted"] == 0 and r["prefill_err"] == r["decode_err"] == r["held_gap"] == 0
    _second_run_on(cs, monkeypatch, flipped)
    r = cs.compare_routed(params, toks, feed, (cfg, "reference"), (cfg, "reference"))
    assert r["parted"] > 0 and r["route_agreement"] < 1
    assert max(r["prefill_err"], r["decode_err"]) > cs.LOGIT_TOL
    assert r["held_gap"] > cs.BF16_ROUTE_TIE_TOL


def test_phase14_first_partings_are_those_no_earlier_parting_reaches(cs, monkeypatch):
    """Layer l's route at position t follows from the layers below l at
    positions up to t, so a parting there is not held; and a fault that
    parts a few tokens' routes in the last layer only (its router's
    column 0 scaled by 3: a sixth of the compared tokens here, each by a
    wide gap) is held to the near-tie."""
    parted = torch.zeros(2, 5, 3, dtype=torch.bool)
    parted[0, 2, 1] = parted[0, 1, 2] = parted[0, 3, 2] = parted[0, 1, 0] = True
    parted[1, 4, 2] = True
    first = cs.first_partings(parted)
    want = torch.zeros_like(parted)
    want[0, 1, 0] = want[1, 4, 2] = True  # (0, 2, 1), (0, 3, 2) follow (0, 1, 0)
    want[0, 1, 2] = False  # (0, 1, 2) follows (0, 1, 0) too
    assert torch.equal(first, want)
    cfg, params = model(cs)
    toks, feed = cs.slice_tokens(cfg, params, 4, 16, 2, 0)
    _second_run_on(cs, monkeypatch, _router_column_scaled(params, cfg.num_layers - 1, 3.0))
    r = cs.compare_routed(params, toks, feed, (cfg, "reference"), (cfg, "reference"))
    assert 0 < r["parted"] <= r["entries"] // 4
    assert r["held_gap"] > cs.BF16_ROUTE_TIE_TOL


# ------------------------------------------------------------------ 14b

def test_phase14b_engine_routes_recorded_by_request(cs, monkeypatch):
    """Both engines' router calls filed by request and position
    (``engine_routes``): sound runs route alike everywhere; the continuous
    engine with a last-layer router column scaled parts routes by wide
    gaps (held to the near-tie), and with the unembedding's columns
    rolled by one parts its outputs past a logit near-tie with no route
    parted before (held too)."""
    cfg, params = model(cs)
    prompts, new = cs.continuous_traffic(cfg, requests=5, max_prompt=40, max_new=8)
    ties, routes = cs.engine_partings(cfg, params, prompts, new, impl="reference")
    assert ties == {} and routes == {i: (0, 0.0) for i in range(5)}
    cs.report_engine_routes(cfg, params, prompts, new, impl="reference")
    real = cs.phase_continuous
    for faulty in (_router_column_scaled(params, cfg.num_layers - 1, 3.0),
                   {**params, "lm_head": {"w": params["lm_head"]["w"].roll(1, dims=1)}}):
        monkeypatch.setattr(cs, "phase_continuous",
                            lambda c, p, *a, _f=faulty, **kw: real(c, _f, *a, **kw))
        with pytest.raises(SystemExit, match="near-tie"):
            cs.report_engine_routes(cfg, params, prompts, new, impl="reference")
    ties, routes = cs.engine_partings(cfg, params, prompts, new, impl="reference")
    past = [i for i, g in ties.items() if g > cs.RECURRENT_TIE_TOL]
    assert past and not any(routes[i][0] for i in past)


# ------------------------------------------------------------- full size

def test_phase14_full_size_and_predictions(cs):
    """2 of 35 layers (55.4 GB in bf16), capacities 20 and 8, the launch
    predictions (none for the capacity dispatch), the expert split's
    divisions, phase 2's G 7 shapes read off the config."""
    cfg = cs.shallow(cs.get_config(cs.ARCTIC), cs.ARCTIC_LAYERS)
    assert cfg.num_layers == 2 and round(2 * cfg.param_count() / 1e9, 1) == 55.4
    assert cs.MOE.capacity(4 * 256, cfg) == 20 and cs.MOE.capacity(4, cfg) == 8
    cap = cs.dataclasses.replace(cfg, moe_dispatch="capacity")
    assert cs.moe_layers(cfg) == 2 and cs.moe_layers(cap) == 0
    prompts = [list(range(n)) for n in (16, 100, 300)]
    assert cs.predicted_launches(cfg, prompts, 64)["grouped_ffn"] == 2 * 64 * 3
    assert cs.predicted_launches(cap, prompts, 64)["grouped_ffn"] == 0
    one = cs.shallow(cfg, 1)
    tp = cs.ARCTIC_EP[1]
    cs.T.check_sharded(one, tp)
    assert (one.n_experts // tp, one.d_ff // tp, one.n_kv_heads // tp) == (32, 1216, 2)
    assert (one.n_heads // one.n_kv_heads, one.head_dim) == (7, 128)
