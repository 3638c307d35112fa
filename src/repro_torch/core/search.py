"""Execution-plan search — Metropolis-Hastings MCMC (paper §5.2).

cost(G_p) = TimeCost(G_p) * (1 if MaxMem < mem_d else alpha)
P(p) ∝ exp(-beta * cost)

Proposal: re-assign one random function call's (mesh, strategy).  The chain
starts from the greedy plan (every call gets its independent time-optimal
assignment on the full cluster), and the best feasible plan seen anywhere in
the chain is returned.  Pruning for >1000-GPU clusters (§8.2, Fig. 14) caps
the per-call candidate list.

The port's copy of the JAX package's ``core/search.py`` (framework-free): it
computes the same numbers, and only its import paths differ.
"""

from __future__ import annotations

import dataclasses
import math
import random
import time as _time
from typing import Callable, Optional

from repro_torch.core.dfg import DataflowGraph, GENERATE, TRAIN
from repro_torch.core.estimator import CostModel, assignment_key
from repro_torch.core.plan import (Assignment, Cluster, DeviceMesh, ExecutionPlan,
                             ParallelStrategy, strategies_for)
from repro_torch.core.simulator import (max_mem_per_device, simulate,
                                  steady_state_time)


@dataclasses.dataclass
class SearchResult:
    best_plan: ExecutionPlan
    best_time: float
    init_time: float
    history: list[tuple[float, float]]  # (wall_clock_s, best_time_so_far)
    evals: int
    space_size: float
    # one record per accepted (improved) plan when searching with a
    # calibrated CostModel: estimated time, how much of it is backed by
    # exact measurements, and the estimated-vs-measured error on those calls
    accepted_log: list[dict] = dataclasses.field(default_factory=list)
    # candidates dropped by the static verifier before costing (see
    # repro.analysis.verify.filter_candidates)
    pruned: int = 0


def candidate_assignments(dfg: DataflowGraph, cluster: Cluster,
                          max_candidates: Optional[int] = None,
                          rng: Optional[random.Random] = None,
                          ) -> dict[str, list[Assignment]]:
    """Legal (mesh, strategy) pairs per call, with the paper's pruning:
    tp within a node, pp <= layers, pipeline fill, mesh fully used."""
    out = {}
    for call in dfg.calls:
        cands = []
        for mesh in cluster.legal_meshes():
            for s in strategies_for(mesh, cluster, call.config.num_layers):
                if call.call_type == GENERATE and s.pp > 8:
                    continue  # decode over deep pipelines: pruned (Fig. 10)
                cands.append(Assignment(mesh, s))
        if max_candidates is not None and len(cands) > max_candidates:
            r = rng or random.Random(0)
            cands = r.sample(cands, max_candidates)
        out[call.name] = cands
    return out


def plan_cost(dfg: DataflowGraph, plan: ExecutionPlan, cost: CostModel,
              mem_cap: float, alpha: float = 100.0,
              unrolled: Optional[DataflowGraph] = None,
              k: int = 1) -> tuple[float, float, bool]:
    """Plan cost; with ``unrolled`` (the paper's concatenated k-iteration
    graph) the objective is the steady-state per-iteration time, which
    rewards cross-iteration overlap of frozen-model calls."""
    if unrolled is not None and k > 1:
        t = steady_state_time(dfg, plan, cost, k, unrolled=unrolled)
    else:
        t = simulate(dfg, plan, cost).total_time
    mem = max_mem_per_device(dfg, plan, cost)
    feasible = mem < mem_cap
    c = t * (1.0 if feasible else alpha)
    return c, t, feasible


def greedy_plan(dfg: DataflowGraph, cluster: Cluster, cost: CostModel,
                cands: dict[str, list[Assignment]]) -> ExecutionPlan:
    """p_0: independently minimize each call's own time cost (paper §5.2)."""
    asg = {}
    for call in dfg.calls:
        best, best_t = None, math.inf
        for a in cands[call.name]:
            t = cost.call_time(call, a)
            if t < best_t:
                best, best_t = a, t
        asg[call.name] = best
    return ExecutionPlan(asg, cluster)


def mcmc_search(dfg: DataflowGraph, cluster: Cluster, cost: CostModel, *,
                mem_cap: Optional[float] = None, beta: float = 0.1,
                alpha: float = 100.0, iters: int = 2000,
                time_limit_s: Optional[float] = None, seed: int = 0,
                max_candidates: Optional[int] = None,
                extra_seeds: Optional[list] = None,
                pipeline_iters: int = 1,
                cands: Optional[dict] = None,
                static_prune: bool = True,
                on_improve: Optional[Callable] = None) -> SearchResult:
    """``extra_seeds``: known-good plans (e.g. the symmetric heuristic) that
    are part of the search space; they are evaluated up front so the returned
    plan is never worse than the best seed.  ``pipeline_iters`` > 1 optimizes
    the steady-state over the paper's concatenated multi-iteration graph
    (cross-iteration overlap of frozen-model inference).  ``cands``
    overrides the per-call candidate lists — the caller's filter (e.g.
    ``replan_on_topology(avoid_nodes=...)``) then bounds every proposal,
    not just the chain's start.  ``static_prune`` runs the static verifier
    first: graph-level errors (cycle, duplicated TRAIN, broken version
    edges) abort the search immediately, and per-call candidates with
    error-level findings (a single call already over the memory cap, an
    empty pipeline stage) are dropped before the chain ever costs them —
    every drop is monotone (such a candidate is infeasible in *any* plan),
    so the feasible optimum is preserved."""
    from repro_torch.core.dfg import unroll_iterations
    rng = random.Random(seed)
    mem_cap = mem_cap or cluster.chip.hbm_bytes
    unrolled = (unroll_iterations(dfg, pipeline_iters)
                if pipeline_iters > 1 else None)
    if cands is None:
        cands = candidate_assignments(dfg, cluster, max_candidates, rng)
    pruned = 0
    if static_prune:
        from repro_torch.analysis.verify import (PlanVerificationError, errors,
                                           filter_candidates, verify_graph)
        graph_errs = errors(verify_graph(dfg))
        if graph_errs:
            raise PlanVerificationError(graph_errs, context="search")
        cands, pruned = filter_candidates(dfg, cluster, cands, cost, mem_cap)
    space = 1.0
    for c in dfg.calls:
        space *= max(len(cands[c.name]), 1)

    t0 = _time.monotonic()
    cur = greedy_plan(dfg, cluster, cost, cands)
    cur_cost, cur_time, cur_feas = plan_cost(dfg, cur, cost, mem_cap, alpha,
                                             unrolled, pipeline_iters)
    init_time = cur_time
    best, best_time = (cur.copy(), cur_time) if cur_feas else (None, math.inf)
    history = [(0.0, best_time)]
    evals = 1
    for sp in (extra_seeds or []):
        s_cost, s_time, s_feas = plan_cost(dfg, sp, cost, mem_cap, alpha,
                                           unrolled, pipeline_iters)
        evals += 1
        if s_feas and s_time < best_time:
            best, best_time = sp.copy(), s_time
        if s_cost < cur_cost:  # start the chain from the best seed
            cur, cur_cost = sp.copy(), s_cost

    call_names = [c.name for c in dfg.calls]
    for it in range(iters):
        if time_limit_s is not None and _time.monotonic() - t0 > time_limit_s:
            break
        name = rng.choice(call_names)
        prop = cur.copy()
        prop.assignments[name] = rng.choice(cands[name])
        p_cost, p_time, p_feas = plan_cost(dfg, prop, cost, mem_cap, alpha,
                                           unrolled, pipeline_iters)
        evals += 1
        # Metropolis-Hastings acceptance on the energy distribution
        accept = p_cost <= cur_cost or (
            rng.random() < math.exp(-beta * (p_cost - cur_cost)))
        if accept:
            cur, cur_cost = prop, p_cost
        if p_feas and p_time < best_time:
            best, best_time = prop.copy(), p_time
            history.append((_time.monotonic() - t0, best_time))
            if on_improve:
                on_improve(it, best, best_time)

    if best is None:  # no feasible plan found; return the least-bad one
        best, best_time = cur.copy(), cur_time
    history.append((_time.monotonic() - t0, best_time))
    return SearchResult(best, best_time, init_time, history, evals, space,
                        pruned=pruned)


def brute_force(dfg: DataflowGraph, cluster: Cluster, cost: CostModel, *,
                mem_cap: Optional[float] = None,
                max_evals: int = 2_000_000) -> SearchResult:
    """Exhaustive search for tiny clusters (paper Fig. 15 reference line)."""
    import itertools
    mem_cap = mem_cap or cluster.chip.hbm_bytes
    cands = candidate_assignments(dfg, cluster)
    names = [c.name for c in dfg.calls]
    space = 1.0
    for n in names:
        space *= len(cands[n])
    if space > max_evals:
        raise ValueError(f"search space {space:.2e} too large for brute force")
    t0 = _time.monotonic()
    best, best_time = None, math.inf
    evals = 0
    for combo in itertools.product(*(cands[n] for n in names)):
        plan = ExecutionPlan(dict(zip(names, combo)), cluster)
        _, t, feas = plan_cost(dfg, plan, cost, mem_cap)
        evals += 1
        if feas and t < best_time:
            best, best_time = plan, t
    return SearchResult(best, best_time, math.inf,
                        [(_time.monotonic() - t0, best_time)], evals, space)


# ----------------------------------------------------- calibrated entry point

def _calibration_check(dfg: DataflowGraph, plan: ExecutionPlan,
                       cost: CostModel) -> dict:
    """Estimated-vs-measured agreement of one plan under a calibrated cost
    model: for every call whose (type, workload, assignment shape) has an
    exact measurement, compare the *analytic* estimate (what the searcher
    would have used without that measurement) against the measured seconds."""
    errs = []
    for call in dfg.calls:
        asg = plan.assignments[call.name]
        if cost.table is None:
            break
        meas = cost.table.lookup_exact(
            call.call_type, call.workload.batch, call.workload.seq_len,
            assignment_key(asg))
        if meas is None:
            continue
        est = cost.analytic_call_time(call, asg)
        errs.append(abs(est - meas) / meas)
    errs.sort()
    return {
        "measured_frac": len(errs) / max(len(dfg.calls), 1),
        "median_rel_err": errs[len(errs) // 2] if errs else None,
    }


def search(dfg: DataflowGraph, cluster: Cluster,
           cost: Optional[CostModel] = None, *,
           profile_store=None, model_cfg=None,
           log: Optional[Callable[[str], None]] = None,
           **mcmc_kw) -> SearchResult:
    """Plan search with optional profile calibration — the paper's
    profile -> estimate -> search pipeline in one call.

    ``cost`` may be a pre-calibrated CostModel; alternatively pass a
    ``profile_store`` (core/profiler.ProfileStore) plus the ``model_cfg``
    whose persisted entry (this hardware's fingerprint) calibrates a fresh
    one.  Falls back to the pure analytic model when neither is available.
    Every accepted improvement is appended to ``SearchResult.accepted_log``
    with its estimated time (seconds) and, where exact measurements cover
    the plan's calls, the estimated-vs-measured relative error; ``log``
    (default: no-op) receives the same records as formatted lines.
    """
    if cost is None:
        entry = None
        if profile_store is not None and model_cfg is not None:
            entry = profile_store.get(model_cfg.name)
        cost = (entry.cost_model(cluster) if entry is not None
                else CostModel(cluster))
    log = log or (lambda s: None)
    accepted: list[dict] = []

    user_cb = mcmc_kw.pop("on_improve", None)

    def on_improve(it, plan, t):
        rec = {"iter": it, "est_time_s": t}
        rec.update(_calibration_check(dfg, plan, cost))
        accepted.append(rec)
        err = rec["median_rel_err"]
        log(f"search: accepted plan @iter {it}: est {t:.3f}s, "
            f"{rec['measured_frac']:.0%} of calls measured"
            + (f", est-vs-measured median rel err {err:.2f}"
               if err is not None else ""))
        if user_cb:
            user_cb(it, plan, t)

    res = mcmc_search(dfg, cluster, cost, on_improve=on_improve, **mcmc_kw)
    if res.pruned:
        log(f"search: verifier pruned {res.pruned} candidate assignments "
            "before costing")
    final = {"iter": None, "est_time_s": res.best_time}
    final.update(_calibration_check(dfg, res.best_plan, cost))
    accepted.append(final)
    res.accepted_log = accepted
    return res


# ------------------------------------------------------------ elastic replan

def replan_on_topology(dfg: DataflowGraph, cluster: Cluster, cost: CostModel,
                       *, base_plan: Optional[ExecutionPlan] = None,
                       iters: int = 60, seed: int = 0,
                       pipeline_iters: int = 1,
                       mem_cap: Optional[float] = None,
                       max_candidates: Optional[int] = None,
                       avoid_nodes: tuple[int, ...] = ()) -> ExecutionPlan:
    """Fast plan search for an elastic topology change (host loss, gain, or
    preemption notice).

    Recovery sits on the critical path of a live run, so this is a *short*
    MCMC chain seeded with the projection of the previous plan onto the
    resized cluster: assignments whose mesh still fits are kept verbatim
    (their parameters may not need to move at all); the rest fall back to
    their greedy per-call optimum on the new cluster.  The seed is part of
    the search space, so the returned plan is never worse than the
    projection under the cost model.

    ``avoid_nodes`` serves the *proactive* path: on a preemption notice the
    cluster is unchanged (the doomed host still serves) but no candidate —
    and no kept-verbatim projection — may touch its devices; the search
    runs over the filtered candidate lists, so every proposal avoids the
    doomed host too.
    """
    m = cluster.devs_per_node
    avoid_devs = frozenset(d for n in avoid_nodes
                           for d in range(n * m, (n + 1) * m))
    cands = candidate_assignments(dfg, cluster, max_candidates,
                                  random.Random(seed))
    if avoid_devs:
        cands = {name: [a for a in lst
                        if not (a.mesh.devices(m) & avoid_devs)]
                 for name, lst in cands.items()}
        if any(not lst for lst in cands.values()):
            raise ValueError(
                f"no candidate assignments avoid nodes {sorted(avoid_nodes)}")
    seeds = []
    if base_plan is not None:
        asg = {}
        for call in dfg.calls:
            a = base_plan.assignments.get(call.name)
            if (a is not None and a.mesh.fits(cluster)
                    and not (a.mesh.devices(m) & avoid_devs)):
                asg[call.name] = a
                continue
            best, best_t = None, math.inf
            for cand in cands[call.name]:
                t = cost.call_time(call, cand)
                if t < best_t:
                    best, best_t = cand, t
            asg[call.name] = best
        if all(a is not None for a in asg.values()):
            seeds.append(ExecutionPlan(asg, cluster))
    res = mcmc_search(dfg, cluster, cost, iters=iters, seed=seed,
                      extra_seeds=seeds, pipeline_iters=pipeline_iters,
                      mem_cap=mem_cap, max_candidates=max_candidates,
                      cands=cands)
    return res.best_plan


# ------------------------------------------------------- reference baselines

def heuristic_plan(dfg: DataflowGraph, cluster: Cluster,
                   cost: CostModel) -> ExecutionPlan:
    """REAL-Heuristic: Megatron-style symmetric 3D parallelism on the global
    mesh — intra-node TP, inter-node PP, DP maximized within memory."""
    mesh = cluster.full_mesh()
    mem_cap = cluster.chip.hbm_bytes
    biggest = max((c.config for c in dfg.calls),
                  key=lambda c: c.param_count())
    best = None
    for s in strategies_for(mesh, cluster, biggest.num_layers):
        plan = ExecutionPlan({c.name: Assignment(mesh, s) for c in dfg.calls},
                             cluster)
        mem = max_mem_per_device(dfg, plan, cost)
        if mem >= mem_cap:
            continue
        t = simulate(dfg, plan, cost).total_time
        # prefer max dp (pre-training heuristic), break ties by time
        key = (-s.dp, t)
        if best is None or key < best[0]:
            best = (key, plan)
    if best is None:
        raise ValueError("no feasible symmetric plan")
    return best[1]
