"""The port's ``RuntimeEngine`` against the JAX package's on the deterministic
PPO-shaped toy of ``test_fault.py`` (four calls on a logical 2 x 2 cluster,
train updates x -> x * 0.5 + r, so the weights after k iterations are an
exact function of the retired call sequence).  Both engines run the same
toy, one on JAX arrays and one on torch tensors, with reallocation logical
(``sharding_for=None``: the port has no physical resharding yet and
refuses one), and must agree exactly: final weights, version counts and
each model's call order; the depth-2 pools against depth 1; retries under
a ``RetryPolicy``; straggler detection and speculative re-dispatch;
host-loss recovery (live and from a checkpoint) with bit-identical
weights; ``recalibrate`` refitting the cost model from the records.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import hw as jhw
from repro.checkpoint.manager import CheckpointManager as JCheckpointManager
from repro.configs import ARCHS as JARCHS
from repro.core import dfg as JD
from repro.core import estimator as JE
from repro.core import fault as JF
from repro.core import plan as JP
from repro.core import runtime as JRT
from repro_torch import hw as thw
from repro_torch.checkpoint.manager import CheckpointManager as TCheckpointManager
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.core import dfg as TD
from repro_torch.core import estimator as TE
from repro_torch.core import fault as TF
from repro_torch.core import plan as TP
from repro_torch.core import runtime as TRT

PKGS = {"jax": dict(D=JD, E=JE, F=JF, P=JP, RT=JRT, hw=jhw, ARCHS=JARCHS,
                    ckpt=JCheckpointManager, full=lambda v: jnp.full((4, 4), v, jnp.float32)),
        "torch": dict(D=TD, E=TE, F=TF, P=TP, RT=TRT, hw=thw, ARCHS=TARCHS,
                      ckpt=TCheckpointManager,
                      full=lambda v: torch.full((4, 4), v, dtype=torch.float32))}


def toy(pkg, *, actor_nodes="full", sleep_s=0.01):
    """``test_fault._toy`` in package ``pkg`` ("jax" or "torch"), without
    shardings.  Returns (dfg, plan, executors, models, replanner, counts)."""
    m = PKGS[pkg]
    D, P = m["D"], m["P"]
    cluster = P.Cluster(n_nodes=2, devs_per_node=2, chip=m["hw"].HOST_CPU)
    w = D.Workload(2, 4, 4)
    calls = [D.FunctionCall("gen", "actor", D.GENERATE, None, w, ("prompts",), ("seq",),
                            trainable=True),
             D.FunctionCall("rew", "reward", D.INFERENCE, None, w, ("seq",), ("r",)),
             D.FunctionCall("atrain", "actor", D.TRAIN, None, w, ("r",), ("a_out",),
                            trainable=True),
             D.FunctionCall("ctrain", "critic", D.TRAIN, None, w, ("r",), ("c_out",),
                            trainable=True)]
    dfg = D.DataflowGraph(calls, "chaos-toy")
    node0, node1 = P.DeviceMesh(0, 1, 0, 2), P.DeviceMesh(1, 1, 0, 2)
    if actor_nodes == "full":  # a replica of the actor survives either host
        gen_asg = P.Assignment(cluster.full_mesh(), P.ParallelStrategy(4, 1, 1, 1))
        atrain_asg = P.Assignment(node0, P.ParallelStrategy(1, 2, 1, 1))
    else:  # the actor lives on node 1 only: losing it loses every replica
        gen_asg = P.Assignment(node1, P.ParallelStrategy(2, 1, 1, 1))
        atrain_asg = P.Assignment(node1, P.ParallelStrategy(1, 2, 1, 1))
    plan = P.ExecutionPlan({"gen": gen_asg,
                            "rew": P.Assignment(node1, P.ParallelStrategy(2, 1, 1, 1)),
                            "atrain": atrain_asg,
                            "ctrain": P.Assignment(node0, P.ParallelStrategy(2, 1, 1, 1))},
                           cluster)
    models = {"actor": m["RT"].ModelState({"w": m["full"](1.0)}),
              "reward": m["RT"].ModelState({}),
              "critic": m["RT"].ModelState({"w": m["full"](2.0)})}
    counts = {}

    def bump(name):
        counts[name] = counts.get(name, 0) + 1

    def gen(ms, inputs):
        time.sleep(sleep_s)
        bump("gen")
        return {"seq": inputs["prompts"]}

    def rew(ms, inputs):
        time.sleep(sleep_s)
        bump("rew")
        return {"r": 2 * inputs["seq"] + 1}

    def mk_train(name, out_key):
        def train(ms, inputs):
            time.sleep(sleep_s)
            bump(name)
            r = float(inputs["r"])
            ms.params = {"w": ms.params["w"] * 0.5 + r}
            return {out_key: r}
        return train

    executors = {"gen": gen, "rew": rew, "atrain": mk_train("atrain", "a_out"),
                 "ctrain": mk_train("ctrain", "c_out")}

    def replanner(new_cluster, event):
        """Everything data-parallel on the resized full mesh, the actor's
        train call tensor-parallel."""
        full = new_cluster.full_mesh()
        dp = P.Assignment(full, P.ParallelStrategy(full.size, 1, 1, 1))
        tp = P.Assignment(full, P.ParallelStrategy(1, full.size, 1, 1))
        return P.ExecutionPlan({"gen": dp, "rew": dp, "atrain": tp, "ctrain": dp}, new_cluster)

    return dfg, plan, executors, models, replanner, counts


class FlatCost:
    """Deadline source for the toy (its calls have no ModelConfig)."""

    def __init__(self, base):
        self.base = base

    def call_time(self, call, asg):
        return self.base


def weights(models):
    return {n: np.asarray(ms.params["w"]) for n, ms in models.items() if ms.params}


def call_order(records):
    """Each model's calls in record order, as (name, iteration)."""
    model_of = {"gen": "actor", "atrain": "actor", "rew": "reward", "ctrain": "critic"}
    out = {}
    for r in records:
        out.setdefault(model_of[r.name], []).append((r.name, r.iteration))
    return out


def run_both(steps=3, *, depth=1, engine_kw=None, toy_kw=None, injector=None):
    """The same toy run on both engines: {pkg: (engine, models, pools, counts)}."""
    out = {}
    for pkg in PKGS:
        dfg, plan, executors, models, replanner, counts = toy(pkg, **(toy_kw or {}))
        kw = dict(engine_kw or {})
        if injector is not None:
            kw["fault_injector"] = injector(PKGS[pkg]["F"])
        eng = PKGS[pkg]["RT"].RuntimeEngine(dfg, plan, executors, models, pipeline_depth=depth,
                                            replanner=replanner, **kw)
        pools = eng.run(lambda t: {"prompts": t}, steps=steps)
        out[pkg] = (eng, models, pools, counts)
    return out


def assert_same(runs, *, records=True):
    (je, jm, jp, jc), (te, tm, tp, tc) = runs["jax"], runs["torch"]
    assert [p["r"] for p in tp] == [p["r"] for p in jp]
    assert tc == jc
    jw, tw = weights(jm), weights(tm)
    assert jw.keys() == tw.keys()
    for n in jw:
        np.testing.assert_array_equal(tw[n], jw[n])
    assert {n: ms.version for n, ms in tm.items()} == {n: ms.version for n, ms in jm.items()}
    if records:
        assert call_order(te.records) == call_order(je.records)
        assert [(r.name, r.iteration, r.attempts, r.retried, r.straggled) for r in
                sorted(te.records, key=lambda r: (r.iteration, r.name))] == \
            [(r.name, r.iteration, r.attempts, r.retried, r.straggled) for r in
             sorted(je.records, key=lambda r: (r.iteration, r.name))]


def test_engines_agree_on_weights_versions_and_call_order():
    runs = run_both(3)
    assert_same(runs)
    _, models, pools, _ = runs["torch"]
    assert [p["r"] for p in pools] == [1, 3, 5]
    assert models["actor"].version == 3 and models["reward"].version == 0


def test_depth2_pools_equal_depth1():
    """Two iterations in flight give the barriered run's pools and weights,
    and the version edge holds: gen@t starts after atrain@t-1 ends."""
    d1, d2 = run_both(4, depth=1), run_both(4, depth=2)
    for pkg in PKGS:
        assert d2[pkg][2] == d1[pkg][2]
        for n, w in weights(d1[pkg][1]).items():
            np.testing.assert_array_equal(weights(d2[pkg][1])[n], w)
    assert_same(d2, records=False)
    recs = {(r.name, r.iteration): r for r in d2["torch"][0].records}
    for t in range(1, 4):
        assert recs[("gen", t)].start >= recs[("atrain", t - 1)].end


def test_retry_under_policy_matches_jax():
    """Two transient failures of ``rew`` retried under a 3-attempt policy
    with exponential backoff; exhausting a 2-attempt one propagates."""
    policy = {pkg: PKGS[pkg]["F"].RetryPolicy(max_attempts=3, backoff_s=0.02,
                                              backoff_factor=2.0) for pkg in PKGS}
    runs = {}
    for pkg in PKGS:
        dfg, plan, executors, models, _, counts = toy(pkg)
        inj = PKGS[pkg]["F"].FaultInjector().fail_transient("rew", times=2)
        eng = PKGS[pkg]["RT"].RuntimeEngine(dfg, plan, executors, models, fault_injector=inj,
                                            retry_policy=policy[pkg])
        t0 = time.monotonic()
        pools = eng.run(lambda t: {"prompts": t}, steps=2)
        assert time.monotonic() - t0 >= 0.06  # slept 0.02 then 0.04
        assert [f[0] for f in inj.fired] == ["transient", "transient"]
        assert eng.stats()["retries"] == 1
        runs[pkg] = (eng, models, pools, counts)
    assert_same(runs)
    dfg, plan, executors, models, _, _ = toy("torch", sleep_s=0.0)
    eng = TRT.RuntimeEngine(dfg, plan, executors, models,
                            fault_injector=TF.FaultInjector().fail_transient("rew", times=10),
                            retry_policy=TF.RetryPolicy(max_attempts=2))
    with pytest.raises(TF.TransientError):
        eng.run(lambda t: {"prompts": t}, steps=2)
    assert eng.iterations_done == 0


@pytest.mark.parametrize("speculative", [False, True])
def test_straggler_detection_matches_jax(speculative):
    """A call delayed past twice its estimate is flagged a straggler in both
    engines; with speculative re-dispatch a duplicate races it on an idle
    mesh and wins, and TRAIN is never duplicated."""
    seen = {pkg: [] for pkg in PKGS}
    runs = {}
    for pkg in PKGS:
        dfg, plan, executors, models, _, counts = toy(pkg)
        inj = PKGS[pkg]["F"].FaultInjector().delay_call("rew", seconds=0.4, at_iteration=1)
        eng = PKGS[pkg]["RT"].RuntimeEngine(
            dfg, plan, executors, models, cost_model=FlatCost(0.05), straggler_factor=2.0,
            fault_injector=inj, speculative_redispatch=speculative,
            on_straggler=lambda n, took, dl, pkg=pkg: seen[pkg].append(n))
        runs[pkg] = (eng, models, eng.run(lambda t: {"prompts": t}, steps=3), counts)
    assert seen["torch"] == seen["jax"] == ["rew"]
    assert_same(runs)
    for pkg in PKGS:
        s = runs[pkg][0].stats()
        assert (s["stragglers"], s["speculative_dispatches"], s["speculative_wins"]) == \
            ((1, 1, 1) if speculative else (1, 0, 0))
        assert runs[pkg][3]["rew"] == (4 if speculative else 3)


def test_host_loss_recovers_live_bit_identical():
    """Host 1 dies during rew@1: both engines mask it, replan on the
    surviving node, resume after iteration 1 without replaying completed
    calls, and end with the uninterrupted run's weights."""
    ref = run_both(3)
    runs = run_both(3, injector=lambda F: F.FaultInjector().kill_host(1, at_call="rew",
                                                                       at_iteration=1))
    assert_same(runs, records=False)
    for pkg in PKGS:
        eng, models, pools, counts = runs[pkg]
        assert counts == {"gen": 3, "rew": 3, "atrain": 3, "ctrain": 3}
        (rec,) = eng.recoveries
        assert (rec["mode"], rec["dead_nodes"], rec["resumed_iteration"]) == ("live", [1], 1)
        assert eng.plan.cluster.n_nodes == 1
        for n, w in weights(ref[pkg][1]).items():
            np.testing.assert_array_equal(weights(models)[n], w)


def test_all_replicas_lost_restores_from_checkpoint(tmp_path):
    """The actor lives on host 1 only: its loss restores the actor from the
    checkpoint each engine's retirement hook wrote, through each package's
    manager, and the weights still equal the uninterrupted run's."""
    ref = run_both(3, toy_kw=dict(actor_nodes=1))
    for pkg in PKGS:
        dfg, plan, executors, models, replanner, counts = toy(pkg, actor_nodes=1)
        ckpt = PKGS[pkg]["ckpt"](tmp_path / pkg, keep=5)
        inj = PKGS[pkg]["F"].FaultInjector().kill_host(1, at_call="rew", at_iteration=1)

        def restore(lost, models=models, ckpt=ckpt):
            assert lost == ["actor"]
            _, trees, _ = ckpt.restore({"actor": models["actor"].params})
            models["actor"].params = trees["actor"]

        eng = PKGS[pkg]["RT"].RuntimeEngine(dfg, plan, executors, models, fault_injector=inj,
                                            replanner=replanner, restore_models=restore)
        pools = eng.run(lambda t: {"prompts": t}, steps=3,
                        on_retire=lambda t, pool, models=models, ckpt=ckpt:
                        ckpt.save(t, {"actor": models["actor"].params}))
        assert [p["r"] for p in pools] == [1, 3, 5]
        assert eng.recoveries[0]["mode"] == "checkpoint"
        assert eng.recoveries[0]["lost_models"] == ["actor"]
        for n, w in weights(ref[pkg][1]).items():
            np.testing.assert_array_equal(weights(models)[n], w)


def test_recalibrate_refits_from_records_as_jax():
    """One inference call of reduced qwen2-0.5b on a 1 x 2 cluster: the
    engine folds its measured record into the cost model at retirement
    (``recalibrate_every=1``); fed the same record, the port's cost model
    refits to the JAX package's scales and estimate exactly."""
    got = {}
    for pkg in PKGS:
        m = PKGS[pkg]
        D, P, E = m["D"], m["P"], m["E"]
        cfg = m["ARCHS"]["qwen2-0.5b"].reduced()
        cluster = P.Cluster(n_nodes=1, devs_per_node=2, chip=m["hw"].HOST_CPU)
        call = D.FunctionCall("work", "m", D.INFERENCE, cfg, D.Workload(2, 16, 0),
                              inputs=(), outputs=("x",))
        dfg = D.DataflowGraph([call], "toy")
        asg = P.Assignment(P.DeviceMesh(0, 1, 0, 1), P.ParallelStrategy(1, 1, 1, 1))
        cost = E.CostModel(cluster, table=_table(pkg, cfg.name))
        eng = m["RT"].RuntimeEngine(dfg, P.ExecutionPlan({"work": asg}, cluster),
                                    {"work": lambda ms, inp: time.sleep(0.02) or {"x": 1}},
                                    {"m": m["RT"].ModelState({})}, cost_model=cost,
                                    recalibrate_every=1)
        eng.run_iteration({})
        assert eng.recalibrations == 1 and cost.n_measurements() == 1
        measured = eng.records[0].end - eng.records[0].start
        assert measured >= 0.02
        hit = cost.table.lookup_exact(D.INFERENCE, 2, 16, E.assignment_key(asg))
        assert hit == measured and cost.call_time(call, asg) == hit
        # the same measurement folded by hand into a fresh model of each package
        fresh = E.CostModel(cluster, table=_table(pkg, cfg.name))
        fresh.record_measurement(call, asg, 0.02)
        fresh.refit()
        got[pkg] = (dict(fresh.type_scales), fresh.call_time(call, asg),
                    fresh.analytic_call_time(call, asg))
    assert got["torch"] == got["jax"]


def _table(pkg, name):
    if pkg == "jax":
        from repro.core.profiler import ProfileTable
    else:
        from repro_torch.core.profiler import ProfileTable
    return ProfileTable(name, {})


def test_physical_resharding_raises():
    """``sharding_for`` (and ``opt_sharding_for``) asks for physical
    resharding, which the port does not have: the engine refuses it at
    construction, naming the ROADMAP item, instead of skipping it."""
    dfg, plan, executors, models, _, _ = toy("torch")
    for kw in (dict(sharding_for=lambda name, asg: {"w": None}),
               dict(opt_sharding_for=lambda name, asg: None)):
        with pytest.raises(NotImplementedError, match="ROADMAP Queue 1 item 5"):
            TRT.RuntimeEngine(dfg, plan, executors, models, **kw)
