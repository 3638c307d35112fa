"""The port's ``RuntimeEngine`` against the JAX package's on the deterministic
PPO-shaped toy of ``test_fault.py`` (four calls on a logical 2 x 2 cluster,
train updates x -> x * 0.5 + r, so the weights after k iterations are an
exact function of the retired call sequence).  Both engines run the same
toy, one on JAX arrays and one on torch tensors, and must agree exactly:
final weights, version counts and each model's call order; the depth-2
pools against depth 1; retries under a ``RetryPolicy``; straggler detection
and speculative re-dispatch; host-loss recovery (live and from a
checkpoint) with bit-identical weights; ``recalibrate`` refitting the cost
model from the records.  These run with logical reallocation
(``sharding_for=None``) in-process.

With physical layouts (``sharding_for`` / ``opt_sharding_for``), the JAX
engine needs several devices: one JAX subprocess per module (4 forced host
devices) runs four sharded toys through it, and the port runs them on
logical CPU meshes: ``test_realloc_fastpath.py``'s prefetch-hit toy on
reduced llama-7b's tree (gen and other data-parallel over 4 devices, train
on 2 x 2), ``benchmarks/pipeline_bench.py``'s toy (half of the actor's
leaves change layout) at depth 2 against depth 1, and ``test_fault.py``'s
host-loss (live, optimizer moments on ``opt_sharding_for``) and
all-replicas-lost (checkpoint restored onto layouts) toys with every
assignment laid out on its own devices.  The engines must give equal
weights and moments, versions, call order, realloc bytes per record and
recovery records.
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


# --------------------------------------------------------- physical layouts

class JaxLayouts:
    """The JAX side of the sharded toys (runs in the 4-device subprocess)."""

    pkg = "jax"

    def __init__(self):
        import jax
        from jax.sharding import Mesh, NamedSharding, PartitionSpec
        from repro.parallel import sharding as SH
        self.jax, self.Mesh, self.NS, self.P, self.SH = jax, Mesh, NamedSharding, PartitionSpec, SH

    def mesh(self, ids, axes):
        return self.Mesh(np.array(self.jax.devices())[np.asarray(ids)], axes)

    def layout(self, mesh, spec):
        return self.NS(mesh, self.P(*spec))

    def place(self, arr, layout):
        return self.jax.device_put(jnp.asarray(arr), layout)

    def map(self, x, fn):
        return fn(x)

    def fold(self, x, m):
        return x * 0.5 + m

    def spec(self, x):
        return tuple(x.sharding.spec), sorted(d.id for d in x.sharding.device_set)

    def maximum(self, x):
        return float(jnp.max(x))

    def value(self, x):
        return np.asarray(x)

    def tree_map(self, fn, *trees):
        return self.jax.tree.map(fn, *trees)

    def param_specs(self, tree, mesh):
        sh = self.SH
        return sh.sanitize_specs(sh.param_specs(tree, sh.ShardingRules()), tree, mesh)


class TorchLayouts:
    """The port's side: logical meshes placed on ``device``."""

    pkg = "torch"

    def __init__(self, device="cpu"):
        from repro_torch.parallel import layout as LY
        from repro_torch.parallel import sharding as SH
        self.LY, self.SH, self.device = LY, SH, device

    def mesh(self, ids, axes):
        return self.LY.Mesh(ids, axes, device=self.device)

    def layout(self, mesh, spec):
        return self.LY.Layout(mesh, self.LY.P(*spec))

    def place(self, arr, layout):
        return self.LY.ShardedTensor.place(torch.from_numpy(np.asarray(arr)), layout)

    def map(self, x, fn):
        return x.map_blocks(fn)

    def fold(self, x, m):
        """x * 0.5 + m block by block: a train call's moments sit on its
        weights' layout (``opt_sharding_for`` gives the same one)."""
        assert x.layout.is_equivalent_to(m.layout, x.ndim)
        return self.LY.ShardedTensor(x.shape, x.dtype, x.layout,
                                     {d: b * 0.5 + m.blocks[d] for d, b in x.blocks.items()})

    def spec(self, x):
        assert isinstance(x, self.LY.ShardedTensor)
        return tuple(x.layout.spec), sorted(x.layout.device_set)

    def maximum(self, x):  # computed on the blocks
        return max(float(b.max()) for _, _, b in x.shards)

    def value(self, x):
        return x.gather("cpu").numpy()

    def tree_map(self, fn, *trees):
        return self.LY.tree_map(fn, *trees)

    def param_specs(self, tree, mesh):
        sh = self.SH
        return sh.sanitize_specs(sh.param_specs(tree, sh.ShardingRules()), tree, mesh)


def llama_tree():
    """Reduced llama-7b's parameter tree in the port's structure, as numpy
    (one dict per layer; a JAX pytree as well)."""
    from repro_torch.models import model as TM
    from repro_torch.parallel.layout import tree_map
    params = TM.init_params(TARCHS["llama-7b"].reduced(), seed=0, device="cpu")
    return tree_map(lambda t: t.numpy(), params)


def jsonable(x):
    import json
    return json.loads(json.dumps(x, default=str))


def toy_prefetch_hit(bk):
    """``test_realloc_fastpath.py``'s prefetch-hit toy: gen and other on 4
    devices data-parallel (FSDP over data), train on 2 x 2 (FSDP x TP) of
    the same devices; the actor's tree is reduced llama-7b's; ``ex_train``
    checks every leaf's layout and computes on it."""
    m = PKGS[bk.pkg]
    D, P, RT = m["D"], m["P"], m["RT"]
    cluster = P.Cluster(n_nodes=1, devs_per_node=4)
    w = D.Workload(batch=4, prompt_len=8, gen_len=8)
    calls = [D.FunctionCall("gen", "actor", D.GENERATE, None, w, inputs=("prompts",),
                            outputs=("seq",)),
             D.FunctionCall("other", "aux", D.INFERENCE, None, w, inputs=("seq",),
                            outputs=("x",)),
             D.FunctionCall("train", "actor", D.INFERENCE, None, w, inputs=("x",),
                            outputs=("y",))]
    dfg = D.DataflowGraph(calls, "toy")
    mesh_all = P.DeviceMesh(0, 1, 0, 4)
    plan = P.ExecutionPlan({
        "gen": P.Assignment(mesh_all, P.ParallelStrategy(4, 1, 1, 1)),
        "other": P.Assignment(mesh_all, P.ParallelStrategy(4, 1, 1, 1)),
        "train": P.Assignment(mesh_all, P.ParallelStrategy(2, 2, 1, 1))}, cluster)
    tree = llama_tree()
    gen_mesh, trn_mesh = bk.mesh([[0], [1], [2], [3]], ("data", "model")), \
        bk.mesh([[0, 1], [2, 3]], ("data", "model"))
    gen_l = bk.tree_map(lambda s: bk.layout(gen_mesh, s), bk.param_specs(tree, gen_mesh))
    trn_specs = bk.param_specs(tree, trn_mesh)
    trn_l = bk.tree_map(lambda s: bk.layout(trn_mesh, s), trn_specs)

    def sharding_for(model_name, asg):
        if model_name != "actor":
            return None
        return trn_l if asg.strategy.tp == 2 else gen_l

    params = bk.tree_map(bk.place, tree, gen_l)
    models = {"actor": RT.ModelState(params, assignment=plan.assignments["gen"]),
              "aux": RT.ModelState({"z": m["full"](0.0)})}
    seen = []

    def ex_train(ms, inputs):
        got = [bk.spec(x) for x in tleaves(bk, ms.params)]
        want = [(tuple(s), [0, 1, 2, 3]) for s in tleaves(bk, trn_specs)]
        seen.append(got == want)
        return {"y": max(bk.maximum(x) for x in tleaves(bk, ms.params))}

    executors = {"gen": lambda ms, i: {"seq": 1},
                 "other": lambda ms, i: (time.sleep(0.3), {"x": 2})[1],
                 "train": ex_train}
    eng = RT.RuntimeEngine(dfg, plan, executors, models, sharding_for=sharding_for)
    out = eng.run_iteration({"prompts": 0})
    st = eng.stats()
    back = [bk.value(x) for x in tleaves(bk, models["actor"].params)]
    same = all(np.array_equal(a, b) for a, b in zip(back, tleaves(bk, tree)))
    return jsonable(dict(
        y=out["y"], layouts_seen=seen, values_kept=same, prefetch_hits=st["prefetch_hits"],
        realloc_bytes=st["realloc_bytes"],
        records=sorted((r.name, r.realloc_bytes) for r in eng.records)))


def tleaves(bk, tree):
    if bk.pkg == "jax":
        return bk.jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, bk.P))
    from repro_torch.parallel.layout import tree_leaves
    return tree_leaves(tree)


def toy_pipeline(bk, *, depth, steps=3, dim=32, n_leaves=8):
    """``benchmarks/pipeline_bench.py``'s toy on 4 devices: the actor on
    devices 0-1, half its leaves (P(x, None) at gen, P(None, x) at train)
    flip layout, half stay replicated."""
    m = PKGS[bk.pkg]
    D, P, RT = m["D"], m["P"], m["RT"]
    cluster = P.Cluster(n_nodes=1, devs_per_node=4)
    w = D.Workload(batch=4, prompt_len=8, gen_len=8)
    calls = [D.FunctionCall("gen", "actor", D.GENERATE, None, w, ("prompts",), ("seq",),
                            trainable=True),
             D.FunctionCall("rew", "reward", D.INFERENCE, None, w, ("seq",), ("r",)),
             D.FunctionCall("atrain", "actor", D.TRAIN, None, w, ("r",), ("a_out",),
                            trainable=True),
             D.FunctionCall("ctrain", "critic", D.TRAIN, None, w, ("r",), ("c_out",),
                            trainable=True)]
    dfg = D.DataflowGraph(calls, "toy")
    mesh_a, mesh_b = P.DeviceMesh(0, 1, 0, 2), P.DeviceMesh(0, 1, 2, 2)
    plan = P.ExecutionPlan({"gen": P.Assignment(mesh_a, P.ParallelStrategy(2, 1, 1, 1)),
                            "rew": P.Assignment(mesh_b, P.ParallelStrategy(2, 1, 1, 1)),
                            "atrain": P.Assignment(mesh_a, P.ParallelStrategy(1, 2, 1, 1)),
                            "ctrain": P.Assignment(mesh_b, P.ParallelStrategy(2, 1, 1, 1))},
                           cluster)
    mesh = bk.mesh([0, 1], ("x",))
    sh_gen, sh_trn, sh_stay = (bk.layout(mesh, ("x", None)), bk.layout(mesh, (None, "x")),
                               bk.layout(mesh, ()))

    def sharding_for(model_name, asg):
        if model_name != "actor":
            return None
        moving = sh_trn if asg == plan.assignments["atrain"] else sh_gen
        return {f"w{i}": moving if i < n_leaves // 2 else sh_stay for i in range(n_leaves)}

    params = {f"w{i}": bk.place(np.ones((dim, dim), np.float32),
                                sh_gen if i < n_leaves // 2 else sh_stay)
              for i in range(n_leaves)}
    models = {"actor": RT.ModelState(params, assignment=plan.assignments["gen"]),
              "reward": RT.ModelState({}), "critic": RT.ModelState({})}

    def mk(name, outs):
        def ex(ms, inputs):
            time.sleep(0.01)
            return {k: (name, tuple(sorted((kk, vv) for kk, vv in inputs.items()
                                           if isinstance(vv, (int, tuple, str)))))
                    for k in outs}
        return ex
    executors = {"gen": mk("gen", ("seq",)), "rew": mk("rew", ("r",)),
                 "atrain": mk("atrain", ("a_out",)), "ctrain": mk("ctrain", ("c_out",))}
    eng = RT.RuntimeEngine(dfg, plan, executors, models, sharding_for=sharding_for,
                           pipeline_depth=depth)
    pools = eng.run(lambda t: {"prompts": t}, steps=steps)
    return jsonable(dict(pools=pools, realloc_bytes=eng.stats()["realloc_bytes"],
                         records=sorted((r.name, r.iteration, r.realloc_bytes)
                                        for r in eng.records)))


def fault_toy(bk, *, actor_nodes="full", dim=4):
    """``test_fault._toy(opt=True)`` with physical layouts: every assignment
    laid out on its own devices as a (dp, tp) mesh, the weights and moments
    replicated where tp is 1 and column-sharded where it is 2, placed at
    start on their first calls' layouts."""
    m = PKGS[bk.pkg]
    dfg, plan, _, _, replanner, counts = toy(bk.pkg, actor_nodes=actor_nodes)
    RT = m["RT"]

    def layout_of(asg):
        ids = sorted(asg.mesh.devices(2))
        s = asg.strategy
        mesh = bk.mesh(np.reshape(ids, (s.dp, s.tp)).tolist(), ("data", "model"))
        return bk.layout(mesh, (None, "model") if s.tp > 1 else ())

    def sharding_for(model_name, asg):
        return {"w": layout_of(asg)} if model_name in ("actor", "critic") else None

    first = {"actor": plan.assignments["gen"], "critic": plan.assignments["ctrain"]}
    opt_first = {"actor": plan.assignments["atrain"], "critic": plan.assignments["ctrain"]}
    models = {"reward": RT.ModelState({})}
    for name, v in (("actor", 1.0), ("critic", 2.0)):
        full = np.full((dim, dim), v, np.float32)
        models[name] = RT.ModelState({"w": bk.place(full, layout_of(first[name]))},
                                     {"w": bk.place(np.zeros_like(full),
                                                    layout_of(opt_first[name]))})

    def bump(name):
        counts[name] = counts.get(name, 0) + 1

    def gen(ms, inputs):
        time.sleep(0.01)
        bump("gen")
        return {"seq": inputs["prompts"]}

    def rew(ms, inputs):
        time.sleep(0.01)
        bump("rew")
        return {"r": 2 * inputs["seq"] + 1}

    def mk_train(name, out_key):
        def train(ms, inputs):
            time.sleep(0.01)
            bump(name)
            r = float(inputs["r"])
            ms.opt_state = {"w": bk.map(ms.opt_state["w"], lambda x: x * 0.9 + r)}
            mom = ms.opt_state["w"]
            ms.params = {"w": bk.fold(ms.params["w"], mom)}
            return {out_key: r}
        return train
    executors = {"gen": gen, "rew": rew, "atrain": mk_train("atrain", "a_out"),
                 "ctrain": mk_train("ctrain", "c_out")}
    return dfg, plan, executors, models, sharding_for, replanner, counts


def fault_summary(bk, eng, models, pools, counts):
    return jsonable(dict(
        r=[p["r"] for p in pools], counts=counts,
        weights={n: bk.value(ms.params["w"]).tolist() for n, ms in models.items() if ms.params},
        moments={n: bk.value(ms.opt_state["w"]).tolist() for n, ms in models.items()
                 if ms.opt_state},
        layouts={n: [bk.spec(ms.params["w"])] for n, ms in models.items() if ms.params},
        versions={n: ms.version for n, ms in models.items()},
        order=call_order(eng.records),
        realloc=sorted((r.name, r.iteration, r.realloc_bytes) for r in eng.records),
        opt_bytes=eng.stats()["opt_state_resharded_bytes"],
        recoveries=[(x["mode"], x["dead_nodes"], x["lost_models"], x["resumed_iteration"],
                     x["moved_bytes"]) for x in eng.recoveries]))


def toy_host_loss(bk):
    """Host 1 dies during rew@1; live recovery reshards the weights and the
    moments onto the survivor plan."""
    dfg, plan, executors, models, sharding_for, replanner, counts = fault_toy(bk)
    inj = PKGS[bk.pkg]["F"].FaultInjector().kill_host(1, at_call="rew", at_iteration=1)
    eng = PKGS[bk.pkg]["RT"].RuntimeEngine(dfg, plan, executors, models,
                                           sharding_for=sharding_for,
                                           opt_sharding_for=sharding_for,
                                           fault_injector=inj, replanner=replanner)
    pools = eng.run(lambda t: {"prompts": t}, steps=3)
    out = fault_summary(bk, eng, models, pools, counts)
    ref = fault_toy(bk)
    eng = PKGS[bk.pkg]["RT"].RuntimeEngine(*ref[:4], sharding_for=ref[4],
                                           opt_sharding_for=ref[4])
    pools = eng.run(lambda t: {"prompts": t}, steps=3)
    out["uninterrupted"] = fault_summary(bk, eng, ref[3], pools, ref[6])
    return out


def toy_all_replicas_lost(bk, ckpt_dir):
    """The actor lives on host 1 only: its loss restores the weights and the
    moments from the checkpoint onto a one-device layout
    (``restore(shardings=...)``), and the engine reshards them onto the
    survivor plan."""
    dfg, plan, executors, models, sharding_for, replanner, counts = fault_toy(
        bk, actor_nodes=1)
    ckpt = PKGS[bk.pkg]["ckpt"](ckpt_dir, keep=5)
    inj = PKGS[bk.pkg]["F"].FaultInjector().kill_host(1, at_call="rew", at_iteration=1)
    one = bk.layout(bk.mesh([0], ("x",)), ())

    def restore(lost):
        assert lost == ["actor"]
        st = models["actor"]
        _, trees, _ = ckpt.restore({"actor": st.params, "actor_opt": st.opt_state},
                                   shardings={"actor": {"w": one}, "actor_opt": {"w": one}})
        st.params, st.opt_state = trees["actor"], trees["actor_opt"]

    eng = PKGS[bk.pkg]["RT"].RuntimeEngine(dfg, plan, executors, models,
                                           sharding_for=sharding_for,
                                           opt_sharding_for=sharding_for,
                                           fault_injector=inj, replanner=replanner,
                                           restore_models=restore)
    pools = eng.run(lambda t: {"prompts": t}, steps=3,
                    on_retire=lambda t, pool: ckpt.save(
                        t, {"actor": models["actor"].params,
                            "actor_opt": models["actor"].opt_state}))
    return fault_summary(bk, eng, models, pools, counts)


JAX_SCRIPT = """
import json, sys, tempfile
sys.path.insert(0, {tests!r})
import jax
assert len(jax.devices()) == 4, jax.devices()
import test_torch_runtime as T
bk = T.JaxLayouts()
out = dict(prefetch_hit=T.toy_prefetch_hit(bk),
           pipeline_d1=T.toy_pipeline(bk, depth=1), pipeline_d2=T.toy_pipeline(bk, depth=2),
           host_loss=T.toy_host_loss(bk),
           all_lost=T.toy_all_replicas_lost(bk, tempfile.mkdtemp()))
print("JAX_RESULT " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_sharded():
    import json
    import os
    import subprocess
    import sys
    import textwrap
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(here, "..", "src"), JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(JAX_SCRIPT.format(tests=here))],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    line = next(x for x in r.stdout.splitlines() if x.startswith("JAX_RESULT "))
    return json.loads(line[len("JAX_RESULT "):])


def test_sharded_prefetch_hit_equals_jax(jax_sharded):
    """The train call sees every leaf on the 2 x 2 layout (a
    ``ShardedTensor``), its prefetch hits, and both engines move the same
    bytes per call; the values come back bit for bit."""
    got, want = toy_prefetch_hit(TorchLayouts()), jax_sharded["prefetch_hit"]
    assert got == want
    assert got["layouts_seen"] == [True] and got["values_kept"]
    assert got["prefetch_hits"] >= 1 and got["realloc_bytes"] > 0


def test_sharded_pipeline_depth2_equals_depth1_and_jax(jax_sharded):
    """Depth 2 gives depth 1's pools; only the flipping half of the actor's
    bytes moves per reshard, as in the JAX engine."""
    bk = TorchLayouts()
    d1, d2 = toy_pipeline(bk, depth=1), toy_pipeline(bk, depth=2)
    assert d2["pools"] == d1["pools"]
    assert d1 == jax_sharded["pipeline_d1"] and d2 == jax_sharded["pipeline_d2"]
    moved = {b for _, _, b in d2["records"] if b}
    assert moved == {4 * 32 * 32 * 4}  # 4 of 8 leaves of 32 x 32 fp32


def test_sharded_host_loss_recovers_live_as_jax(jax_sharded):
    """Live recovery with weights and moments on layouts: the same weights,
    moments, versions, call order, realloc bytes and recovery record as the
    JAX engine, and the uninterrupted run's weights bit for bit."""
    got = toy_host_loss(TorchLayouts())
    assert got == jax_sharded["host_loss"]
    assert got["recoveries"][0][:2] == ["live", [1]]
    for k in ("weights", "moments", "versions"):
        assert got[k] == got["uninterrupted"][k]
    assert got["recoveries"][0][4] > 0  # the weights moved onto the survivors


def test_sharded_all_replicas_lost_restores_onto_layouts_as_jax(jax_sharded, tmp_path):
    """Every replica of the actor lost: the checkpoint restores onto a
    one-device layout and the engine reshards it onto the survivor plan, as
    the JAX engine does, with the uninterrupted run's weights."""
    got = toy_all_replicas_lost(TorchLayouts(), tmp_path)
    assert got == jax_sharded["all_lost"]
    assert got["recoveries"][0][:3] == ["checkpoint", [1], ["actor"]]
    ref = toy_host_loss(TorchLayouts())["uninterrupted"]
    assert got["r"] == [1, 3, 5]
    assert got["weights"]["critic"] == ref["weights"]["critic"]
