"""The slice as a whole: the port's ``RLHFExperiment`` (plan search, cost
model, executors, ``RuntimeEngine``) against the JAX package's, and a CPU
rehearsal of ``chip_smoke.py``'s phase 8.

Both experiments run reduced qwen2-0.5b as actor and critic on
``Cluster(1, 1)`` with the same seed and ``search_iters``: their searched
plans are identical.  With the JAX package's weights bridged into the port
(embedding scaled by 0.05, as everywhere: one-hot otherwise), the same
prompts and ``top_k=1`` (so the rollout does not depend on either
package's random draws), one ``engine.run_iteration`` of each, padded and
packed, gives equal tokens; logprobs, reference logprobs, values and
rewards within 1e-5; train stats within 1e-5 relative; and the updated
parameters within ``PARAM_TOL`` (``test_torch_train.py``'s tolerances,
AdamW at eps 1e-6 as there).
"""

import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.core.plan import Cluster as JCluster
from repro.optim import adamw as jadamw
from repro.rlhf import experiment as JEXP
from repro.rlhf import ppo as JPPO
from repro_torch.configs import get_config
from repro_torch.core.plan import Cluster as TCluster
from repro_torch.kernels import ops
from repro_torch.optim import adamw as tadamw
from repro_torch.rlhf import experiment as TEXP
from repro_torch.rlhf import ppo as TPPO
from test_torch_train import PARAM_TOL, _np, _t, assert_trees_close, bridged

KW = dict(batch=4, prompt_len=8, gen_len=8, seed=3, search_iters=40, top_k=1)


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    """The engine runs executors in pool threads on top of torch's intra-op
    threads; two of those keep the reference-tier math from oversubscribing
    the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def experiments(packed=False, depth=1):
    """(JAX experiment, port experiment) of reduced qwen2-0.5b on
    ``Cluster(1, 1)``, the port's on the CPU at the reference tier."""
    jcfg, tcfg = JARCHS["qwen2-0.5b"].reduced(), get_config("qwen2-0.5b").reduced()
    kw = dict(KW, packed_training=packed, pipeline_depth=depth)
    je = JEXP.RLHFExperiment(jcfg, jcfg, JCluster(1, 1), JEXP.ExperimentConfig(
        ppo=JPPO.PPOHyperparameters(n_minibatches=2), opt=jadamw.AdamWConfig(eps=1e-6), **kw))
    te = TEXP.RLHFExperiment(tcfg, tcfg, TCluster(1, 1), TEXP.ExperimentConfig(
        ppo=TPPO.PPOHyperparameters(n_minibatches=2), opt=tadamw.AdamWConfig(eps=1e-6),
        impl="reference", **kw), device="cpu")
    return je, te


def bridge_weights(je, te):
    """The JAX experiment's weights, embedding scaled by 0.05, in both
    experiments' ``ModelState``s (the ones their engines hold), with fresh
    AdamW states."""
    for name, jms in je.models.items():
        jms.params = dict(jms.params, embed={"table": jms.params["embed"]["table"] * 0.05})
        tms = te.models[name]
        tms.params = bridged(jms.params)
        if jms.opt_state is not None:
            jms.opt_state = jadamw.init(je.exp.opt, jms.params)
            for p in tadamw.leaves(tms.params):
                p.requires_grad_(True)
            tms.opt_state = tadamw.init(te.exp.opt, tms.params)


def plan_key(plan):
    return sorted((k, str(a.mesh), str(a.strategy)) for k, a in plan.assignments.items())


@pytest.mark.parametrize("depth", [1, 2])
def test_searched_plan_equals_jax(depth):
    """The same graph, cost model and MCMC seed give the same plan (at
    pipeline depth 2 ranked on the steady-state time of the unrolled
    graph)."""
    je, te = experiments(depth=depth)
    assert plan_key(te.plan) == plan_key(je.plan)
    assert [c.name for c in te.graph.calls] == [c.name for c in je.graph.calls]


@pytest.mark.parametrize("packed", [False, True], ids=["padded", "packed"])
def test_engine_iteration_matches_jax(packed):
    """One ``engine.run_iteration`` of each experiment on the same prompts
    and weights: the pools and the updated actor and critic agree."""
    je, te = experiments(packed=packed)
    bridge_weights(je, te)
    toks = np.random.default_rng(5).integers(1, te.actor_cfg.vocab_size,
                                             (KW["batch"], KW["prompt_len"])).astype(np.int32)
    want = je.engine.run_iteration({"prompts": {"tokens": jax.numpy.asarray(toks)}})
    got = te.engine.run_iteration({"prompts": {"tokens": _t(toks).long()}})
    np.testing.assert_array_equal(got["seq"].numpy(), np.asarray(want["seq"]))
    for key in ("logp", "ref_logp", "values", "rewards", "gen_mask"):
        np.testing.assert_allclose(_np(got[key]), np.asarray(want[key]), atol=1e-5, rtol=1e-5,
                                   err_msg=key)
    for key in ("actor_stats", "critic_stats"):
        assert set(got[key]) == set(want[key])
        for k in want[key]:
            np.testing.assert_allclose(got[key][k], want[key][k], rtol=1e-5, atol=1e-7,
                                       err_msg=f"{key} {k}")
    for name in ("actor", "critic"):
        assert_trees_close(te.models[name].params, je.models[name].params, atol=PARAM_TOL)
        assert te.models[name].version == je.models[name].version == 1
    assert {r.name for r in te.engine.records} == {r.name for r in je.engine.records}


def test_pipelined_run_equals_barriered():
    """``run(steps=2)`` at pipeline depth 2 returns depth 1's pools and
    leaves the same weights: the version edges keep every rollout
    on-policy, and the prompts of iteration t come from its own
    generator."""
    runs = []
    for depth in (1, 2):
        _, te = experiments(depth=depth)
        pools = te.run(11, steps=2)
        runs.append((pools, [p.detach().clone() for p in tadamw.leaves(te.models["actor"].params)],
                     te.engine.stats()))
    (p1, w1, s1), (p2, w2, s2) = runs
    for a, b in zip(p1, p2):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], torch.Tensor):
                assert torch.equal(a[k], b[k]), k
            elif k != "prompts":
                assert a[k] == b[k], k
    assert all(torch.equal(a, b) for a, b in zip(w1, w2))
    assert s1["iterations"] == s2["iterations"] == 2


def test_topology_replans_equal_jax():
    """The experiments' replanner on a 2 x 2 cluster: after losing host 1
    (the survivors compacted to one node), after gaining a host, and on a
    preemption notice for host 1 (the same cluster, host 1 avoided), the
    port's short MCMC picks the JAX package's plan."""
    from repro.core import fault as JF
    from repro_torch.core import fault as TF
    jcfg, tcfg = JARCHS["qwen2-0.5b"].reduced(), get_config("qwen2-0.5b").reduced()
    kw = dict(KW, replan_iters=30)
    je = JEXP.RLHFExperiment(jcfg, jcfg, JCluster(2, 2), JEXP.ExperimentConfig(**kw))
    te = TEXP.RLHFExperiment(tcfg, tcfg, TCluster(2, 2), TEXP.ExperimentConfig(
        impl="reference", **kw), device="cpu")
    assert plan_key(te.plan) == plan_key(je.plan)
    for kind, nodes, (n, m) in (("loss", (1,), (1, 2)), ("gain", (2,), (3, 2)),
                                ("notice", (1,), (2, 2))):
        want = je._replan_on_topology(JCluster(n, m), JF.TopologyEvent(kind, nodes))
        got = te._replan_on_topology(TCluster(n, m), TF.TopologyEvent(kind, nodes))
        assert plan_key(got) == plan_key(want), kind
        assert te.cluster.n_nodes == je.cluster.n_nodes


def test_experiment_checkpoints_and_restores(tmp_path):
    """``checkpoint_every=1``: each iteration's models and AdamW states are
    written at retirement; restoring step 1 after a second iteration brings
    back the first iteration's weights and optimizer state bit for bit."""
    tcfg = get_config("qwen2-0.5b").reduced()
    te = TEXP.RLHFExperiment(tcfg, tcfg, TCluster(1, 1), TEXP.ExperimentConfig(
        impl="reference", checkpoint_every=1, checkpoint_dir=str(tmp_path),
        ppo=TPPO.PPOHyperparameters(n_minibatches=2), **KW),
        device="cpu")
    te.run_iteration(0)
    saved = [x.detach().clone() if isinstance(x, torch.Tensor) else x
             for x in tadamw.leaves([te.models["actor"].params, te.models["actor"].opt_state])]
    te.run(1, steps=1)
    te.ckpt.wait()
    assert te.ckpt.latest_step() == 2
    assert te.restore_checkpoint(step=1) == 1
    now = tadamw.leaves([te.models["actor"].params, te.models["actor"].opt_state])
    assert all(torch.equal(a, b) if isinstance(b, torch.Tensor) else a == b
               for a, b in zip(now, saved))
    assert all(p.requires_grad for p in tadamw.leaves(te.models["actor"].params))


def test_entry_points_refuse_cuda_without_a_card(monkeypatch):
    """``RLHFExperiment`` and the quickstart run on the card by default;
    with no card they raise, and nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2-0.5b").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TEXP.RLHFExperiment(cfg, cfg, TCluster(1, 1), TEXP.ExperimentConfig(search_iters=5))
    from repro_torch import quickstart
    with pytest.raises(RuntimeError, match="no CUDA device"):
        quickstart.main([])


def test_quickstart_runs_on_cpu(capsys):
    from repro_torch import quickstart
    quickstart.main(["--device", "cpu", "--iters", "2"])
    out = capsys.readouterr().out
    assert "ExecutionPlan(" in out and out.count("actor_loss=") == 2


# ------------------------------------------------ chip_smoke rehearsal

@pytest.fixture(scope="module")
def chip_smoke():
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(root))
    return chip_smoke


def test_chip_smoke_engine_phase_on_cpu(chip_smoke, monkeypatch):
    """Phase 8 at the reduced size on the reference tier: the profile, the
    calibrated experiment and its plan, the engine's iteration bit-equal to
    the hand-driven loop (the two hand runs agree bit for bit here), the
    per-call estimates finite and positive, depth 2 equal to depth 1, and
    the ops calls that stand in for kernel launches equal the prediction in
    every run (the profile's are not counted)."""
    cfg = chip_smoke.get_config("qwen2-0.5b").reduced()
    exp = chip_smoke.train_experiment(batch=4, prompt_len=8, new=8, impl="reference",
                                      packed=False)
    calls = {"mha": 0, "decode_mha": 0}

    def count(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped
    for name in calls:
        monkeypatch.setattr(ops, name, count(name, getattr(ops, name)))
    r = chip_smoke.phase_engine(cfg, exp, "cpu", profile_batches=(2,), profile_seqs=(8, 16),
                                search_iters=20)
    assert r["profile"]["fingerprint"] == "cpu-1xcpu"
    assert set(r["profile"]["entries"]) == {(k, 2, s) for k in ("train", "inference")
                                            for s in (8, 16)}
    assert set(r["profile"]["scales"]) == {"train", "inference"}
    assert "d1t1p1" in r["plan"] and r["estimated_s"] > 0
    assert r["hand_parts"] == r["engine_parts"] == r["pipelined_parts"] == []
    assert r["spread"] == r["engine_spread"] == r["pipelined_spread"] == 0.0
    assert set(r["calls"]) == {"actor_gen", "ref_inf", "critic_inf", "reward_inf",
                               "actor_train", "critic_train"}
    for c in r["calls"].values():
        assert all(np.isfinite(v) and v > 0 for v in c.values())
    assert r["stats"]["iterations"] == 2 and r["stats"]["recalibrations"] == 1
    n = cfg.num_layers
    want = chip_smoke.train_predicted(cfg, exp)
    assert want == {"flash_mha": 4 * n + 2 * 2 * 2 * n, "flash_decode": 7 * n}
    for key in ("engine_launches", "depth1_launches"):
        assert not any(r[key].values())  # no kernel on the reference tier
    # eight iterations (two hand-driven, two through run_iteration, two runs
    # of two steps), and the profile's train steps and inference forwards
    # (two grid points, two warm-ups and three timed calls of each)
    assert calls["decode_mha"] == 8 * want["flash_decode"]
    assert calls["mha"] == 8 * want["flash_mha"] + 2 * 2 * 5 * n
