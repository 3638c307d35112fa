"""The paper's LLaMA-3 models in the port against the JAX package: the
configs field by field, ``param_count`` and ``core.realloc.layer_bytes``
exactly; the heuristic and MCMC plans for llama-7b as actor and critic on
one and two nodes of 8 H100s, plans and simulated times exactly (as
``test_torch_search.py`` holds the port's own configs); the launcher's
``--plan-only`` printing the JAX search's plan without building a model;
and a reduced llama forward in fp32 on bridged weights within
``test_torch_model.py``'s tolerance.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import hw as jhw
from repro.configs import ARCHS as JARCHS
from repro.configs import llama as jllama
from repro.core import dfg as JD
from repro.core import estimator as JE
from repro.core import plan as JP
from repro.core import realloc as JR
from repro.core import search as JS
from repro.models import model as JM
from repro_torch import hw as thw
from repro_torch.bridge import params_from_jax
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.configs import llama as tllama
from repro_torch.core import dfg as TD
from repro_torch.core import estimator as TE
from repro_torch.core import plan as TP
from repro_torch.core import realloc as TR
from repro_torch.core import search as TS
from repro_torch.launch import train as TRAIN
from repro_torch.models import model as TM
from test_torch_core import plan_key
from test_torch_model import TOL, _dicts, _tokens

NAMES = ("llama-7b", "llama-13b", "llama-34b", "llama-70b")


def pairs():
    """(JAX config, port config) for each paper size and its critic."""
    out = []
    for size in ("7b", "13b", "34b", "70b"):
        j, t = jllama.PAPER_SIZES[size], tllama.PAPER_SIZES[size]
        out += [(j, t), (jllama.critic_of(j), tllama.critic_of(t))]
    return out


@pytest.mark.parametrize("jcfg,tcfg", pairs(), ids=lambda c: c.name)
def test_configs_counts_and_layer_bytes_equal_jax(jcfg, tcfg):
    """Every field of the port's config equals the JAX one (``moe_dispatch``
    and ``dense_residual_ffn`` at their dense defaults in both); the
    parameter counts and per-layer bytes are equal as numbers."""
    def plain(v):  # a layer pattern as tuples (the packages' LayerSpec classes differ)
        return tuple(map(dataclasses.astuple, v)) if isinstance(v, tuple) else v
    for f in dataclasses.fields(tcfg):
        assert plain(getattr(tcfg, f.name)) == plain(getattr(jcfg, f.name)), f.name
    assert {f.name for f in dataclasses.fields(tcfg)} == {f.name for f in dataclasses.fields(jcfg)}
    assert (tcfg.moe_dispatch, tcfg.dense_residual_ffn) == \
        (jcfg.moe_dispatch, jcfg.dense_residual_ffn) == ("dropless", False)
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.active_param_count() == jcfg.active_param_count()
    assert TR.layer_bytes(tcfg) == JR.layer_bytes(jcfg)


def test_registry_holds_the_paper_sizes():
    assert set(tllama.PAPER_SIZES) == set(jllama.PAPER_SIZES)
    for name in NAMES:
        assert TARCHS[name] == tllama.PAPER_SIZES[name.split("-")[1]]
        assert TARCHS[name].name == JARCHS[name].name
    assert TARCHS["llama-7b"].param_count() == 8_030_392_320


def h100_clusters(n_nodes):
    kw = dict(intra_node_bw=450e9, inter_node_bw=50e9)
    return (JP.Cluster(n_nodes, 8, chip=jhw.H100, **kw),
            TP.Cluster(n_nodes, 8, chip=thw.H100, **kw))


def llama_graphs(**kw):
    kw = dict(dict(batch=16, prompt_len=128, gen_len=256, n_minibatches=2), **kw)
    ja, ta = jllama.LLAMA_7B, tllama.LLAMA_7B
    return (JD.build_ppo(ja, jllama.critic_of(ja), **kw),
            TD.build_ppo(ta, tllama.critic_of(ta), **kw))


@pytest.mark.parametrize("n_nodes", [1, 2])
def test_llama_heuristic_plan_equals_jax(n_nodes):
    jcl, tcl = h100_clusters(n_nodes)
    jg, tg = llama_graphs()
    want = JS.heuristic_plan(jg, jcl, JE.CostModel(jcl))
    got = TS.heuristic_plan(tg, tcl, TE.CostModel(tcl))
    assert plan_key(got) == plan_key(want)
    assert str(got) == str(want)


@pytest.mark.parametrize("n_nodes", [1, 2])
def test_llama_mcmc_plan_equals_jax(n_nodes):
    """``mcmc_search(iters=200)`` for llama-7b actor and critic on 8 and 16
    H100s: the best plan, its simulated time, the evaluation count and the
    pruning, for two seeds."""
    jcl, tcl = h100_clusters(n_nodes)
    jg, tg = llama_graphs()
    for seed in (0, 1):
        want = JS.mcmc_search(jg, jcl, JE.CostModel(jcl), iters=200, seed=seed)
        got = TS.mcmc_search(tg, tcl, TE.CostModel(tcl), iters=200, seed=seed)
        assert plan_key(got.best_plan) == plan_key(want.best_plan)
        assert got.best_time == want.best_time and got.init_time == want.init_time
        assert (got.evals, got.space_size, got.pruned) == (want.evals, want.space_size,
                                                            want.pruned)


def test_plan_only_prints_the_jax_plan_and_builds_no_model(capsys, monkeypatch):
    """``launch.train --plan-only --arch llama-7b --nodes 2 --devs-per-node 8
    --h100`` prints the plan the JAX launcher's search finds (its
    ``RLHFExperiment`` searches ``build_ppo(cfg, cfg)`` with a fresh
    ``CostModel``, 500 iterations, seed 0), and no model is built."""
    def refuse(*a, **k):
        raise AssertionError("--plan-only built a model")
    monkeypatch.setattr(TM, "init_params", refuse)
    plan = TRAIN.main(["--plan-only", "--arch", "llama-7b", "--nodes", "2",
                       "--devs-per-node", "8", "--h100"])
    out = capsys.readouterr().out
    jcl, _ = h100_clusters(2)
    cfg = JARCHS["llama-7b"]
    graph = JD.build_ppo(cfg, cfg, batch=4, prompt_len=8, gen_len=8, n_minibatches=2)
    want = JS.mcmc_search(graph, jcl, JE.CostModel(jcl), iters=500, seed=0,
                          pipeline_iters=1).best_plan
    assert plan_key(plan) == plan_key(want)
    assert str(want) in out
    assert out.startswith(f"arch=llama-7b params={cfg.param_count() / 1e6:.1f}M cluster=2x8")


def test_plan_only_plans_llama_70b_without_its_weights(capsys, monkeypatch):
    """llama-70b (70.6B parameters, four models of it in an experiment)
    plans on the host in seconds: nothing is allocated."""
    monkeypatch.setattr(TM, "init_params", lambda *a, **k: pytest.fail("built a model"))
    plan = TRAIN.main(["--plan-only", "--arch", "llama-70b", "--nodes", "2",
                       "--devs-per-node", "8", "--h100", "--search-iters", "50"])
    assert set(plan.assignments) == {"actor_gen", "reward_inf", "ref_inf", "critic_inf",
                                     "actor_train", "critic_train"}
    assert "ExecutionPlan(" in capsys.readouterr().out


def llama_pair(head="lm", seed=0):
    """Reduced llama-7b (2 layers, fp32) with the JAX package's weights
    bridged into the port, biases absent, norm scales randomised and the
    embedding scaled by 0.05 as ``test_torch_model.make_pair`` does."""
    jcfg, tcfg = JARCHS["llama-7b"].reduced(), TARCHS["llama-7b"].reduced()
    tree = jax.tree.map(np.array, JM.init_params(jax.random.PRNGKey(seed), jcfg, head=head))
    rng = np.random.default_rng(seed)
    tree["embed"]["table"] *= 0.05
    for parent in _dicts(tree):
        if "scale" in parent:
            parent["scale"] = (1 + rng.normal(0, 0.1, parent["scale"].shape)).astype(np.float32)
    return jcfg, jax.tree.map(jnp.asarray, tree), tcfg, params_from_jax(tree, tcfg, device="cpu")


def test_reduced_llama_forward_matches_jax():
    """Untied LM head, GQA 4/2, rope theta 5e5: hidden states, logits and
    the prefill's last-position logits within ``TOL``."""
    jcfg, jp, tcfg, tp = llama_pair()
    assert "lm_head" in tp and tcfg.rope_theta == 5e5
    toks = _tokens(4, 2, 24, jcfg.vocab_size)
    jh, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, remat=False)
    th = TM.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)}, impl="reference")
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(TM.logits_of(tp, tcfg, th).numpy(),
                               np.asarray(JM.logits_of(jp, jcfg, jh)), atol=TOL, rtol=TOL)
    jlast, _ = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, 32)
    tlast, _ = TM.prefill(tp, tcfg, {"tokens": torch.from_numpy(toks)}, 32, impl="reference")
    np.testing.assert_allclose(TM.logits_of(tp, tcfg, tlast[:, None]).numpy(),
                               np.asarray(JM.logits_of(jp, jcfg, jlast[:, None])),
                               atol=TOL, rtol=TOL)


def test_reduced_llama_critic_values_match_jax():
    """The critic's trunk with the fp32 scalar value head."""
    jcfg, jp, tcfg, tp = llama_pair(head="value", seed=1)
    assert "value_head" in tp and "lm_head" not in tp
    toks = _tokens(5, 2, 16, jcfg.vocab_size)
    jh, _ = JM.forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, remat=False)
    th = TM.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)}, impl="reference")
    np.testing.assert_allclose(TM.values_of(tp, th).numpy(), np.asarray(JM.values_of(jp, jh)),
                               atol=TOL, rtol=TOL)


def test_train_launcher_runs_iterations_and_checkpoints(tmp_path, capsys):
    """Without ``--plan-only`` the launcher builds ``RLHFExperiment`` and
    runs PPO iterations through the engine (reduced qwen2-0.5b on the
    reference tier here), checkpointing actor and critic every 5 steps."""
    from repro_torch.checkpoint.manager import CheckpointManager
    run = TRAIN.main(["--smoke", "--device", "cpu", "--impl", "reference", "--steps", "5",
                      "--search-iters", "20", "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.count("actor_loss=") == 5 and out.rstrip().endswith("done")
    assert run.iteration == 5
    mgr = CheckpointManager(tmp_path)
    assert mgr.latest_step() == 5
    step, trees, _ = mgr.restore({"actor": run.models["actor"].params})
    from repro_torch.optim.adamw import leaves
    for a, b in zip(leaves(trees["actor"]), leaves(run.models["actor"].params)):
        assert torch.equal(a, b.detach())
