"""The port's planning layer against the JAX package's: the param counts, the
cost model, the reallocation schedule, the simulator, the heuristic and MCMC
plan searches and the static verifier.  They are framework-free copies and
must compute the same numbers, so every comparison is exact equality (no
tolerance): the same candidate order and the same float arithmetic give the
same plans, bit for bit, from the same ``random.Random`` seeds.

Each test runs over the four configs the port serves, at full width and
depth and reduced, on PPO graphs of 16 prompts of 128 tokens and 256 new
(the chip_smoke phase 8 traffic) on ``Cluster(2, 4)``.
"""

import dataclasses
import importlib

import pytest

from repro.configs import ARCHS as JARCHS
from repro.core import dfg as JD
from repro.core import estimator as JE
from repro.core import plan as JP
from repro.core import realloc as JR
from repro.core import search as JS
from repro.core import simulator as JSIM
from repro_torch.analysis import verify as TV
from repro_torch.configs import ARCHS as TARCHS
from repro_torch.core import dfg as TD
from repro_torch.core import estimator as TE
from repro_torch.core import plan as TP
from repro_torch.core import realloc as TR
from repro_torch.core import search as TS
from repro_torch.core import simulator as TSIM

JV = importlib.import_module("repro.analysis.verify")  # the package exports a `verify` function
ARCHS = ("qwen2-0.5b", "granite-moe-1b-a400m", "mamba2-1.3b", "recurrentgemma-9b")
CASES = [pytest.param(a, r, id=f"{a}-{'reduced' if r else 'full'}")
         for a in ARCHS for r in (False, True)]


def configs(arch, reduced):
    j, t = JARCHS[arch], TARCHS[arch]
    return (j.reduced(), t.reduced()) if reduced else (j, t)


def graphs(arch, reduced, packed=False):
    jc, tc = configs(arch, reduced)
    kw = dict(batch=16, prompt_len=128, gen_len=256, n_minibatches=2, packed=packed)
    return JD.build_ppo(jc, jc, **kw), TD.build_ppo(tc, tc, **kw)


def clusters(n_nodes=2, devs=4):
    return JP.Cluster(n_nodes, devs), TP.Cluster(n_nodes, devs)


def to_port(asg):
    """A JAX package ``Assignment`` as the port's."""
    return TP.Assignment(TP.DeviceMesh(*dataclasses.astuple(asg.mesh)),
                         TP.ParallelStrategy(*dataclasses.astuple(asg.strategy)))


def plan_key(plan):
    """A plan as plain tuples: {call: (mesh, strategy)}."""
    return {k: (dataclasses.astuple(a.mesh), dataclasses.astuple(a.strategy))
            for k, a in plan.assignments.items()}


def plan_to_port(plan, cluster):
    return TP.ExecutionPlan({k: to_port(a) for k, a in plan.assignments.items()}, cluster)


def some_assignments(jcl, num_layers, n=12):
    """Every legal mesh of the cluster with its first and last strategy,
    at most ``n`` of them, in the JAX package's order."""
    out = []
    for mesh in jcl.legal_meshes():
        strats = JP.strategies_for(mesh, jcl, num_layers)
        out += [JP.Assignment(mesh, s) for s in {strats[0], strats[-1]}]
    return sorted(out, key=lambda a: (dataclasses.astuple(a.mesh),
                                      dataclasses.astuple(a.strategy)))[:: max(1, len(out) // n)]


@pytest.mark.parametrize("arch,reduced", CASES)
def test_param_counts_and_layer_bytes_equal_jax(arch, reduced):
    jc, tc = configs(arch, reduced)
    assert tc.param_count() == jc.param_count()
    assert tc.active_param_count() == jc.active_param_count()
    assert [tc.layer_params(s) for s in tc.layers] == [jc.layer_params(s) for s in jc.layers]
    assert TR.layer_bytes(tc) == JR.layer_bytes(jc)
    assert tc.is_subquadratic == jc.is_subquadratic


@pytest.mark.parametrize("arch,reduced", CASES)
def test_cost_model_call_times_equal_jax(arch, reduced):
    """``call_time``, ``call_cost`` and the memory terms of every call of the
    PPO graph (padded and packed where packing applies) on a spread of
    assignments of ``Cluster(2, 4)``."""
    jcl, tcl = clusters()
    jcost, tcost = JE.CostModel(jcl), TE.CostModel(tcl)
    packs = (False, True) if all(s.kind == "attn" for s in JARCHS[arch].layers) else (False,)
    for packed in packs:
        jg, tg = graphs(arch, reduced, packed)
        for jcall, tcall in zip(jg.calls, tg.calls):
            assert tcall.name == jcall.name and tcall.workload == \
                TD.Workload(*dataclasses.astuple(jcall.workload))
            for ja in some_assignments(jcl, jcall.config.num_layers):
                ta = to_port(ja)
                assert tcost.call_time(tcall, ta) == jcost.call_time(jcall, ja)
                assert dataclasses.astuple(tcost.call_cost(tcall, ta)) == \
                    dataclasses.astuple(jcost.call_cost(jcall, ja))
                assert tcost.active_mem_per_dev(tcall, ta) == jcost.active_mem_per_dev(jcall, ja)
                assert TE.assignment_key(ta) == JE.assignment_key(ja)


@pytest.mark.parametrize("arch,reduced", CASES)
def test_remap_schedule_costs_equal_jax(arch, reduced):
    """The Fig. 6 reallocation schedule between pairs of assignments: its
    time, moved layers and communication ops; and the data-transfer time."""
    jcl, tcl = clusters()
    jc, tc = configs(arch, reduced)
    asgs = some_assignments(jcl, jc.num_layers, n=6)
    for src in asgs:
        for dst in asgs:
            js = JR.remap_schedule(jc, src, dst, jcl)
            ts = TR.remap_schedule(tc, to_port(src), to_port(dst), tcl)
            assert ts.time == js.time
            assert ts.moved_layers() == js.moved_layers()
            assert [dataclasses.astuple(o) for o in ts.ops] == \
                [dataclasses.astuple(o) for o in js.ops]
            assert TR.data_transfer_time(1e6, to_port(src), to_port(dst), tcl) == \
                JR.data_transfer_time(1e6, src, dst, jcl)


@pytest.mark.parametrize("arch,reduced", CASES)
def test_simulate_and_steady_state_equal_jax(arch, reduced):
    """``simulate`` (makespan and every node's start and end),
    ``steady_state_time`` over 3 iterations and ``max_mem_per_device`` of the
    greedy plan of each graph."""
    jcl, tcl = clusters()
    jg, tg = graphs(arch, reduced)
    jcost, tcost = JE.CostModel(jcl), TE.CostModel(tcl)
    jplan = JS.greedy_plan(jg, jcl, jcost, JS.candidate_assignments(jg, jcl))
    tplan = plan_to_port(jplan, tcl)
    assert plan_key(TS.greedy_plan(tg, tcl, tcost, TS.candidate_assignments(tg, tcl))) == \
        plan_key(jplan)
    js, ts = JSIM.simulate(jg, jplan, jcost), TSIM.simulate(tg, tplan, tcost)
    assert ts.total_time == js.total_time
    assert ts.timeline() == js.timeline()
    assert TSIM.steady_state_time(tg, tplan, tcost, 3) == JSIM.steady_state_time(jg, jplan,
                                                                                 jcost, 3)
    assert TSIM.max_mem_per_device(tg, tplan, tcost) == JSIM.max_mem_per_device(jg, jplan, jcost)


def _diags(diags):
    return [(d.severity, d.rule, d.message) for d in diags]


@pytest.mark.parametrize("arch,reduced", CASES)
def test_verify_diagnostics_equal_jax(arch, reduced):
    """``verify`` on the greedy plan, and on a broken one (one call's
    strategy no longer covering its mesh, another call moved onto a mesh
    outside the cluster): the same diagnostics, and ``assert_valid``
    refuses the broken plan in both."""
    jcl, tcl = clusters()
    jg, tg = graphs(arch, reduced)
    jcost, tcost = JE.CostModel(jcl), TE.CostModel(tcl)
    jplan = JS.greedy_plan(jg, jcl, jcost, JS.candidate_assignments(jg, jcl))
    tplan = plan_to_port(jplan, tcl)
    assert _diags(TV.verify(tg, tplan, cost=tcost)) == _diags(JV.verify(jg, jplan, cost=jcost))
    broken = jplan.copy()
    gen = broken.assignments["actor_gen"]
    broken.assignments["actor_gen"] = JP.Assignment(
        gen.mesh, dataclasses.replace(gen.strategy, mbs=gen.strategy.mbs * 64))
    broken.assignments["ref_inf"] = JP.Assignment(JP.DeviceMesh(3, 1, 0, 4),
                                                  JP.ParallelStrategy(4, 1, 1, 1))
    tbroken = plan_to_port(broken, tcl)
    want = _diags(JV.verify(jg, broken, cost=jcost))
    assert any(sev == "error" for sev, _, _ in want)
    assert _diags(TV.verify(tg, tbroken, cost=tcost)) == want
    with pytest.raises(JV.PlanVerificationError):
        JV.assert_valid(jg, broken, cost=jcost)
    with pytest.raises(TV.PlanVerificationError):
        TV.assert_valid(tg, tbroken, cost=tcost)
    assert TV.packed_mixer_error(configs(arch, reduced)[1]) == \
        JV.packed_mixer_error(configs(arch, reduced)[0])


@pytest.mark.parametrize("arch,reduced", CASES)
def test_mcmc_search_equals_jax(arch, reduced):
    """``mcmc_search(iters=200)``, one iteration per plan: the best plan,
    its time, the evaluation count and the static pruning, for 3 seeds."""
    check_mcmc(arch, reduced, pipeline_iters=1)


def check_mcmc(arch, reduced, pipeline_iters):
    jcl, tcl = clusters()
    jg, tg = graphs(arch, reduced)
    for seed in (0, 1, 2):
        want = JS.mcmc_search(jg, jcl, JE.CostModel(jcl), iters=200, seed=seed,
                              pipeline_iters=pipeline_iters)
        got = TS.mcmc_search(tg, tcl, TE.CostModel(tcl), iters=200, seed=seed,
                             pipeline_iters=pipeline_iters)
        assert plan_key(got.best_plan) == plan_key(want.best_plan)
        assert got.best_time == want.best_time and got.init_time == want.init_time
        assert (got.evals, got.space_size, got.pruned) == (want.evals, want.space_size,
                                                            want.pruned)
