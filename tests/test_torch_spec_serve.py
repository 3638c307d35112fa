"""The port's speculative entry points above ``spec_generate`` against the
JAX package: the spec mode of ``ContinuousBatchServer`` (greedy parity and
its schedule and ``stats()`` in the scheduling scenarios of
``tests/test_torch_paged.py``, window layers, sampled logprobs),
``build_server`` with a draft, and ``RLHFExperiment`` with
``ExperimentConfig.draft_model`` through ``RuntimeEngine``.

Weights as in ``test_torch_spec.py`` (the draft: the target plus N(0, 0.02)
noise); the experiment bridges the JAX experiment's four models and its
draft.  Tolerances: logprobs 2e-4 (fp32 through the model, as
``tests/test_spec.py``), the experiment's pools 1e-5 and train stats 1e-5
relative or 1e-6 absolute; tokens, schedules, spec counts
and ``k`` traces are held exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.core.plan import Cluster as JCluster
from repro.launch import serve as jserve
from repro.models import spec as JS
from repro.rlhf import experiment as JEXP
from repro.rlhf import ppo as JPPO
from repro.rlhf.experiment import ExperimentConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.core.plan import Cluster as TCluster
from repro_torch.launch import serve as tserve
from repro_torch.models import model as TM
from repro_torch.models import spec as TS
from repro_torch.rlhf import experiment as TEXP
from repro_torch.rlhf import ppo as TPPO
from test_torch_model import make_pair
from test_torch_paged import _generate, _scenario
from test_torch_spec import noisy_draft

TOL = 2e-4
POOL_TOL = 1e-5
# the actor's loss is a sum of ratio x advantage terms that nearly cancel
# (~1e-5 here), so its relative difference reads the fp32 summation order
STAT_ATOL = 1e-6
SPEC_KEYS = ("steps", "preemptions", "peak_blocks", "completion_order", "spec_cycles",
             "spec_accepted", "spec_proposed", "spec_k_trace")


@pytest.fixture(scope="module")
def pair():
    return make_pair(seed=2)


@pytest.fixture(scope="module")
def draft(pair):
    jcfg, jparams, tcfg, _ = pair
    return noisy_draft(jparams, tcfg)


# ----------------------------------------------------------------- server

@pytest.mark.parametrize("name", ["plain", "short_before_long", "preemption", "eos"])
def test_spec_server_greedy_matches_jax_and_generate(pair, draft, name):
    """Greedy speculative serving with the adaptive controller: tokens
    bit-identical to the JAX spec server and to the port's ``generate``,
    logprobs within 2e-4, the same schedule and spec counts and k trace,
    the JAX ``stats()`` keys (but its jit ``compiles``)."""
    jcfg, jparams, tcfg, tparams = pair
    jd, td = draft

    def eos_of(prompt):  # the request's second greedy token
        return int(_generate(tcfg, tparams, prompt, 2)[1])

    kw, prompts, new = _scenario(name, tcfg.vocab_size, eos_of)
    tsrv = tserve.ContinuousBatchServer(tcfg, tparams, impl="reference", draft_params=td,
                                        draft_cfg=tcfg, spec_k=3,
                                        spec_controller=TS.SpecController(init_k=3), **kw)
    jsrv = jserve.ContinuousBatchServer(jcfg, jparams, draft_params=jd, draft_cfg=jcfg,
                                        spec_k=3, spec_controller=JS.SpecController(init_k=3),
                                        **kw)
    ttoks, tlps = tsrv.serve(prompts, max_new=new)
    jtoks, jlps = jsrv.serve(prompts, rng=None, max_new=new)
    for pr, t, j, tl, jl, n in zip(prompts, ttoks, jtoks, tlps, jlps, new):
        np.testing.assert_array_equal(t, np.asarray(j))
        np.testing.assert_allclose(tl, np.asarray(jl), atol=TOL)
        np.testing.assert_array_equal(t, _generate(tcfg, tparams, pr, n)[:len(t)])
    tst, jst = tsrv.stats(), jsrv.stats()
    assert set(tst) == set(jst) - {"compiles"}
    assert {k: tst[k] for k in SPEC_KEYS} == {k: jst[k] for k in SPEC_KEYS}
    assert tst["spec_accept_rate"] == jst["spec_accept_rate"] < 0.5
    assert len(tst["spec_k_trace"]) == tst["spec_cycles"] > 0
    if name == "preemption":
        assert tst["preemptions"] >= 1
    assert not tsrv.queue and not tsrv._active() and tsrv.alloc.used_count == 0


def test_spec_server_window_layers_match_generate():
    """Window layers (window 8; prompts of 16 and generations wrap the
    rings) through the spec server: tokens equal the port's and the JAX
    package's ``generate`` (the JAX spec server is not the yardstick here,
    see ``test_torch_spec.py``)."""
    jcfg, jparams, tcfg, tparams = make_pair(window=8, seed=4)
    _, td = noisy_draft(jparams, tcfg)
    rng = np.random.default_rng(1)
    prompts, new = [rng.integers(1, tcfg.vocab_size, 16).astype(np.int32)
                    for _ in range(3)], [4, 12, 9]
    srv = tserve.ContinuousBatchServer(tcfg, tparams, impl="reference", n_slots=2,
                                       kv_block_size=8, max_prompt=16, max_new=12,
                                       draft_params=td, draft_cfg=tcfg, spec_k=3)
    toks, lps = srv.serve(prompts, max_new=new)
    for pr, t, n in zip(prompts, toks, new):
        want = _generate(tcfg, tparams, pr, n)
        np.testing.assert_array_equal(t, want)
        jwant = jax.numpy.asarray(pr[None])
        from repro.models import model as JM
        np.testing.assert_array_equal(
            t, np.asarray(JM.generate(jparams, jcfg, {"tokens": jwant},
                                      num_new_tokens=n)["tokens"])[0])
    assert 0.0 < srv.stats()["spec_accept_rate"] < 1.0


def test_spec_server_sampled_logprobs_are_teacher_forced(pair, draft):
    """Sampled speculative serving (temperature 0.7, top-k 20, ragged
    prompts left-padded to their bucket): every returned logprob is the
    untempered target's under a teacher-forced ``forward`` (2e-4)."""
    _, _, tcfg, tparams = pair
    _, td = draft
    rng = np.random.default_rng(6)
    prompts = [rng.integers(1, tcfg.vocab_size, n).astype(np.int32) for n in (5, 16, 20)]
    srv = tserve.ContinuousBatchServer(tcfg, tparams, n_slots=2, kv_block_size=8,
                                       max_prompt=32, max_new=7, impl="reference",
                                       temperature=0.7, top_k=20, draft_params=td,
                                       draft_cfg=tcfg, spec_k=2)
    toks, lps = srv.serve(prompts, seed=3)
    for pr, t, lp in zip(prompts, toks, lps):
        assert len(t) == 7
        pb = tserve.bucket_of(len(pr))
        seq = np.zeros(pb + len(t) - 1, np.int64)
        seq[pb - len(pr):pb] = pr
        seq[pb:] = t[:-1]
        with torch.no_grad():
            h = TM.forward(tparams, tcfg, {"tokens": torch.from_numpy(seq[None])},
                           impl="reference")
            logp = torch.log_softmax(TM.logits_of(tparams, tcfg, h)[0, pb - 1:], dim=-1)
        want = logp.gather(-1, torch.from_numpy(t.astype(np.int64))[:, None])[:, 0]
        np.testing.assert_allclose(lp, want.numpy(), atol=TOL)
    assert srv.stats()["spec_accepted"] > 0


def test_build_server_with_a_draft(pair, draft):
    """``build_server`` gives the spec server when the experiment has a
    draft model and draft parameters are passed (adaptive or fixed k), the
    plain one otherwise; a draft without its config, a vocabulary mismatch
    and a recurrent draft raise."""
    jcfg, jparams, tcfg, tparams = pair
    jd, td = draft
    for adaptive in (True, False):
        exp = ExperimentConfig(serve_mode="continuous", draft_model=tcfg, spec_k=3,
                               kv_block_size=4, spec_adaptive=adaptive)
        srv = tserve.build_server(tcfg, tparams, exp, max_prompt=16, max_new=4,
                                  draft_params=td)
        jsrv = jserve.build_server(jcfg, jparams, dataclasses.replace(exp, draft_model=jcfg),
                                   max_prompt=16, max_new=4, draft_params=jd)
        assert srv.draft_cfg is tcfg and srv.spec_k == 3
        assert (srv.max_blocks, srv.d_table.tolist()) == (jsrv.max_blocks,
                                                         jsrv.d_table.tolist())
        if adaptive:
            assert isinstance(srv.spec_controller, TS.SpecController)
            assert srv.spec_controller.k == 3 and srv.spec_controller.k_max == 8
        else:
            assert srv.spec_controller is None
    plain = tserve.build_server(tcfg, tparams, exp, max_prompt=16, max_new=4)
    assert plain.draft_cfg is None and "spec_cycles" not in plain.stats()
    with pytest.raises(ValueError, match="together"):
        tserve.ContinuousBatchServer(tcfg, tparams, draft_params=td)
    with pytest.raises(ValueError, match="vocab"):
        tserve.ContinuousBatchServer(tcfg, tparams, draft_params=td,
                                     draft_cfg=dataclasses.replace(tcfg, vocab_size=99))
    with pytest.raises(ValueError, match="attention-only"):
        tserve.ContinuousBatchServer(tcfg, tparams, draft_params=td,
                                     draft_cfg=get_config("mamba2-1.3b").reduced())
    with pytest.raises(ValueError, match="spec_k"):
        tserve.ContinuousBatchServer(tcfg, tparams, draft_params=td, draft_cfg=tcfg,
                                     spec_k=0)


def test_serve_cli_spec_on_cpu(capsys):
    tserve.main(["--smoke", "--device", "cpu", "--impl", "reference", "--spec",
                 "--requests", "3", "--new", "6"])
    out = capsys.readouterr().out
    assert "served 3 ragged requests" in out and "spec accept_rate=1.000" in out


# ------------------------------------------------------------- experiment

KW = dict(batch=4, prompt_len=8, gen_len=8, seed=3, top_k=1, spec_k=3)


def spec_experiments():
    """(JAX, port) ``RLHFExperiment`` of reduced qwen2-0.5b with a 1-layer
    draft on ``Cluster(1, 1)``, heuristic plans, the JAX models (embedding
    scaled by 0.05) bridged into the port's model states."""
    jcfg, tcfg = JARCHS["qwen2-0.5b"].reduced(), get_config("qwen2-0.5b").reduced()
    jdraft = dataclasses.replace(jcfg, name=jcfg.name + "-draft", num_layers=1, n_superblocks=1)
    tdraft = dataclasses.replace(tcfg, name=tcfg.name + "-draft", num_layers=1, n_superblocks=1)
    je = JEXP.RLHFExperiment(jcfg, jcfg, JCluster(1, 1), JEXP.ExperimentConfig(
        ppo=JPPO.PPOHyperparameters(n_minibatches=2), draft_model=jdraft, **KW), search=False)
    te = TEXP.RLHFExperiment(tcfg, tcfg, TCluster(1, 1), TEXP.ExperimentConfig(
        ppo=TPPO.PPOHyperparameters(n_minibatches=2), draft_model=tdraft, impl="reference",
        **KW), search=False, device="cpu")
    from test_torch_experiment import bridge_weights
    draft = je.models.pop("draft")
    tdraft_ms = te.models.pop("draft")
    bridge_weights(je, te)
    je.models["draft"], te.models["draft"] = draft, tdraft_ms
    draft.params = dict(draft.params, embed={"table": draft.params["embed"]["table"] * 0.05})
    tdraft_ms.params = params_from_jax(jax.tree.map(np.array, draft.params), tdraft,
                                       device="cpu")
    return je, te


def test_experiment_spec_iteration_matches_jax():
    """One ``engine.run_iteration`` of each experiment with a draft model,
    ``top_k=1`` so neither package's draws matter: the same plan (with
    ``draft_gen``), tokens, spec stats and k trace; logprobs, reference
    logprobs, values and rewards within 1e-5; train stats within 1e-5
    relative; the accept rate recorded in the cost model; the draft
    unchanged; the spec executors also build alone."""
    je, te = spec_experiments()
    from test_torch_experiment import plan_key
    assert plan_key(te.plan) == plan_key(je.plan)
    assert "draft_gen" in te.graph.by_name and "draft_gen" in te.plan.assignments
    d0 = [p.clone() for p in TEXP.adamw.leaves(te.models["draft"].params)]
    toks = np.random.default_rng(5).integers(1, te.actor_cfg.vocab_size,
                                             (KW["batch"], KW["prompt_len"])).astype(np.int32)
    want = je.engine.run_iteration({"prompts": {"tokens": jnp.asarray(toks)}})
    got = te.engine.run_iteration({"prompts": {"tokens": torch.from_numpy(toks).long()}})
    np.testing.assert_array_equal(got["seq"].numpy(), np.asarray(want["seq"]))
    for key in ("logp", "ref_logp", "values", "rewards", "gen_mask"):
        np.testing.assert_allclose(got[key].detach().numpy(), np.asarray(want[key]),
                                   atol=POOL_TOL, rtol=POOL_TOL, err_msg=key)
    assert got["spec_stats"] == want["spec_stats"]
    assert 0.0 <= got["spec_stats"]["accept_rate"] <= 1.0 and got["spec_stats"]["proposed"] > 0
    for key in ("actor_stats", "critic_stats"):
        for k in want[key]:
            np.testing.assert_allclose(got[key][k], want[key][k], rtol=1e-5, atol=STAT_ATOL,
                                       err_msg=f"{key} {k}")
            assert np.isfinite(got[key][k])
    assert te.cost.accept_rate("actor", default=-1.0) == je.cost.accept_rate("actor",
                                                                             default=-1.0)
    assert te.spec_controller.history == je.spec_controller.history
    for a, b in zip(TEXP.adamw.leaves(te.models["draft"].params), d0):
        assert torch.equal(a, b)
    ex = TEXP.build_executors(te.actor_cfg, te.actor_cfg, te.exp, draft=te.models["draft"])
    assert set(ex) == set(te.executors)
    with pytest.raises(ValueError, match="draft"):
        TEXP.build_executors(te.actor_cfg, te.actor_cfg, te.exp)


def test_experiment_spec_refusals():
    """As the JAX package: a draft of another vocabulary, a recurrent draft
    and ``eos_id`` with a draft raise at construction."""
    tcfg = get_config("qwen2-0.5b").reduced()
    base = dict(batch=2, prompt_len=8, gen_len=8, impl="reference", search_iters=5)
    for kw, match in ((dict(draft_model=dataclasses.replace(tcfg, vocab_size=99)), "vocab"),
                      (dict(draft_model=get_config("mamba2-1.3b").reduced()), "attention"),
                      (dict(draft_model=tcfg, eos_id=3), "eos_id")):
        with pytest.raises(ValueError, match=match):
            TEXP.RLHFExperiment(tcfg, tcfg, TCluster(1, 1),
                                TEXP.ExperimentConfig(**base, **kw), search=False,
                                device="cpu")


# ------------------------------------------------ chip_smoke rehearsal

@pytest.fixture(scope="module")
def chip_smoke():
    from pathlib import Path
    import sys
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


def _count_ops(monkeypatch):
    """Count the ops calls that stand in for kernel launches on the
    reference tier; the paged verify attention stands in for flash_mha."""
    from repro_torch.kernels import ops
    calls = {"flash_mha": 0, "flash_decode": 0, "paged_flash_decode": 0, "grouped_ffn": 0}

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    for op, name in (("mha", "flash_mha"), ("paged_verify_mha", "flash_mha"),
                     ("decode_mha", "flash_decode"), ("paged_decode_mha", "paged_flash_decode"),
                     ("grouped_ffn", "grouped_ffn")):
        monkeypatch.setattr(ops, op, count(name, getattr(ops, op)))
    return calls


def _total(*counts):
    keys = {k for c in counts for k in c}
    return {k: sum(c.get(k, 0) for c in counts) for k in keys}


def test_chip_smoke_spec_phase_on_cpu(chip_smoke, monkeypatch):
    """Phase 9's functions at the reduced size on the reference tier: the
    draft seeded like the target is the target's embedding and first layer;
    greedy spec equals generate bit for bit (no parting to hold), sampled
    spec logprobs are a teacher-forced forward's (2e-4), the spec server
    equals the plain one (its logprobs also a teacher-forced forward's over
    the bucket-padded prompts, 2e-4), the engine iteration with a draft keeps the draft
    and records the accept rate, the verify layers' CUDA branches (their
    wrappers' CPU paths here) equal the reference (1e-5); and the ops calls
    that stand in for kernel launches equal the prediction in every run."""
    cfg = chip_smoke.get_config("qwen2-0.5b").reduced()
    dcfg = chip_smoke.spec_draft(cfg, 1)
    params = chip_smoke.make_params(cfg, seed=0, device="cpu")
    dparams = chip_smoke.make_params(dcfg, seed=0, device="cpu")
    assert torch.equal(dparams["embed"]["table"], params["embed"]["table"])
    assert torch.equal(dparams["layers"][0]["mixer"]["wq"]["w"],
                       params["layers"][0]["mixer"]["wq"]["w"])
    prompts = chip_smoke.spec_prompts(cfg, "cpu", batch=3, prompt_len=8)
    calls = _count_ops(monkeypatch)
    runs = chip_smoke.phase_spec(cfg, params, dcfg, dparams, prompts, new=10, impl="reference")
    assert chip_smoke.same_launches(calls, _total(*(
        r[k] for r in runs.values() for k in ("predicted", "plain_predicted"))))
    assert calls["flash_mha"] > 0 and calls["paged_flash_decode"] > 0
    assert all(not any(r["spec_launches"].values()) for r in runs.values())
    g = runs["greedy"]
    assert torch.equal(g["spec"][0], g["plain"][0])
    assert np.abs((g["spec"][1] - g["plain"][1]).numpy()).max() < TOL
    assert chip_smoke.spec_partings(cfg, params, prompts, g["spec"][0], g["plain"][0]) == (3, {})
    toks, lps = runs["sampled"]["spec"]
    want, scale = chip_smoke.teacher_forced(cfg, params, prompts, toks, impl="reference")
    assert max(np.abs((a - b).numpy()).max() for a, b in zip(lps, want)) < TOL and scale > 0
    lp = chip_smoke.logprob_errors(cfg, params, prompts, g["spec"], g["plain"],
                                   impl="reference")
    assert lp["n_agree"] == 3 and max(lp["teacher_forced"], lp["agree"]) * lp["scale"] < TOL
    assert not torch.equal(toks, g["spec"][0])

    for k in calls:
        calls[k] = 0
    sprompts, snew = chip_smoke.continuous_traffic(cfg, requests=6, max_prompt=40, max_new=12)
    sr = chip_smoke.phase_spec_server(cfg, params, dcfg, dparams, sprompts, snew,
                                      impl="reference", n_slots=3, block_size=8)
    assert chip_smoke.same_launches(calls, _total(sr["plain"]["predicted"],
                                                  sr["spec"]["predicted"]))
    for a, b in zip(sr["spec"]["outputs"], sr["plain"]["outputs"]):
        np.testing.assert_array_equal(a, b)
    lp = chip_smoke.logprob_errors(cfg, params, sprompts,
                                   (sr["spec"]["outputs"], sr["spec"]["logprobs"]),
                                   (sr["plain"]["outputs"], sr["plain"]["logprobs"]),
                                   impl="reference", bucketed=True)
    assert lp["n_agree"] == 6 and max(lp["teacher_forced"], lp["agree"]) * lp["scale"] < TOL
    assert sr["spec"]["stats"]["spec_cycles"] == sr["spec"]["stats"]["steps"] > 0

    for k in calls:
        calls[k] = 0
    exp = chip_smoke.train_experiment(batch=4, prompt_len=8, new=8, impl="reference",
                                      packed=False)
    en = chip_smoke.phase_spec_engine(cfg, dcfg, exp, "cpu", search_iters=20)
    assert en["draft_equal"] and len(en["iters"]) == 2
    for r in en["iters"]:
        assert r["spec_stats"]["proposed"] > 0 and r["accept_rate"] >= 0.0
        assert "draft_gen" in r["calls"]
        assert all(np.isfinite(v) for s in r["stats"].values() for v in s.values())
    assert chip_smoke.same_launches(calls, _total(*(r["predicted"] for r in en["iters"])))

    monkeypatch.setattr(chip_smoke.OPS, "_check", lambda impl, *tensors: None)
    errs = chip_smoke.verify_layer_errors(cfg, params, "cpu", batch=3, blocks=4, block_size=8,
                                          window=8)
    assert set(errs) == {"paged_verify_mha", "ragged_attn_verify_apply"}
    assert all(e < 1e-5 for e in errs.values())
