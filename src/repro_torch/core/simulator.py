"""Execution-plan simulation — Algorithm 1 (Appendix C) of the paper.

Builds the augmented dataflow graph G_p (function calls + parameter-realloc +
data-transfer nodes) for a plan and computes TimeCost(G_p) by discrete-event
simulation under the constraint that nodes on overlapping device meshes cannot
run concurrently.

The port's copy of the JAX package's ``core/simulator.py`` (framework-free): it
computes the same numbers, and only its import paths differ.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
from typing import Optional

from repro_torch.core import realloc
from repro_torch.core.dfg import (DataflowGraph, FunctionCall, GENERATE, TRAIN,
                            unroll_iterations)
from repro_torch.core.estimator import CostModel
from repro_torch.core.plan import Assignment, Cluster, ExecutionPlan


@dataclasses.dataclass
class SimNode:
    name: str
    kind: str  # call | realloc | xfer
    mesh_devices: frozenset[int]
    duration: float
    parents: list[str]
    # filled by the simulation
    ready: float = 0.0
    start: float = 0.0
    end: float = 0.0


@dataclasses.dataclass
class SimResult:
    total_time: float
    nodes: dict[str, SimNode]
    realloc_time: float
    xfer_time: float

    def timeline(self) -> list[tuple[str, float, float]]:
        return sorted(((n.name, n.start, n.end) for n in self.nodes.values()),
                      key=lambda t: t[1])


def build_augmented_graph(dfg: DataflowGraph, plan: ExecutionPlan,
                          cost: CostModel) -> dict[str, SimNode]:
    """G_p: calls + realloc nodes (param movement between successive calls of
    the same model) + data-transfer nodes on cross-mesh edges."""
    cluster = plan.cluster
    m = cluster.devs_per_node
    nodes: dict[str, SimNode] = {}

    order = dfg.topo_order()
    # where each model's parameters currently live (mesh+strategy)
    param_loc: dict[str, Assignment] = {}
    last_call: dict[str, str] = {}
    extra_parents: dict[str, list[str]] = {c.name: [] for c in dfg.calls}

    for call in order:
        asg = plan.assignments[call.name]
        prev = param_loc.get(call.model_name)
        if prev is not None and (prev.mesh != asg.mesh
                                 or prev.strategy != asg.strategy):
            sched = realloc.remap_schedule(call.config, prev, asg, cluster)
            rname = f"realloc:{call.model_name}->{call.name}"
            # realloc occupies the union of both meshes and depends on the
            # model's previous function call having completed
            devs = prev.mesh.devices(m) | asg.mesh.devices(m)
            parents = ([last_call[call.model_name]]
                       if call.model_name in last_call else [])
            dur = (cost.realloc_time(sched)
                   if hasattr(cost, "realloc_time") else sched.time)
            nodes[rname] = SimNode(rname, "realloc", frozenset(devs),
                                   dur, parents)
            extra_parents[call.name].append(rname)
        param_loc[call.model_name] = asg
        last_call[call.model_name] = call.name

    for call in order:
        asg = plan.assignments[call.name]
        parents = [p.name for p in dfg.parents(call)]
        for p in dfg.parents(call):
            pasg = plan.assignments[p.name]
            if pasg.mesh != asg.mesh:
                xname = f"xfer:{p.name}->{call.name}"
                if xname not in nodes:
                    bytes_ = realloc.data_bytes(p, call)
                    t = realloc.data_transfer_time(bytes_, pasg, asg, cluster)
                    devs = pasg.mesh.devices(m) | asg.mesh.devices(m)
                    nodes[xname] = SimNode(xname, "xfer", frozenset(devs), t,
                                           [p.name])
                parents = [x for x in parents if x != p.name] + [xname]
        dur = cost.call_time(call, asg)
        nodes[call.name] = SimNode(call.name, "call",
                                   asg.mesh.devices(m), dur,
                                   parents + extra_parents[call.name])
    return nodes


def simulate(dfg: DataflowGraph, plan: ExecutionPlan,
             cost: CostModel) -> SimResult:
    """Algorithm 1: priority-queue list scheduling with device exclusivity."""
    nodes = build_augmented_graph(dfg, plan, cost)
    children: dict[str, list[str]] = {n: [] for n in nodes}
    indeg: dict[str, int] = {n: 0 for n in nodes}
    for n in nodes.values():
        for p in n.parents:
            children[p].append(n.name)
            indeg[n.name] += 1

    busy_until: dict[int, float] = {}
    counter = itertools.count()
    heap: list[tuple[float, int, str]] = []
    for n in nodes.values():
        if indeg[n.name] == 0:
            heapq.heappush(heap, (0.0, next(counter), n.name))

    completed = 0
    while heap:
        ready, _, name = heapq.heappop(heap)
        node = nodes[name]
        dev_free = max((busy_until.get(d, 0.0) for d in node.mesh_devices),
                       default=0.0)
        node.ready = ready
        node.start = max(ready, dev_free)
        node.end = node.start + node.duration
        for d in node.mesh_devices:
            busy_until[d] = node.end
        completed += 1
        for ch in children[name]:
            nodes[ch].ready = max(nodes[ch].ready, node.end)
            indeg[ch] -= 1
            if indeg[ch] == 0:
                heapq.heappush(heap, (nodes[ch].ready, next(counter), ch))

    if completed != len(nodes):
        raise ValueError("graph has a cycle or unreachable nodes")
    total = max(n.end for n in nodes.values())
    return SimResult(
        total_time=total,
        nodes=nodes,
        realloc_time=sum(n.duration for n in nodes.values()
                         if n.kind == "realloc"),
        xfer_time=sum(n.duration for n in nodes.values() if n.kind == "xfer"),
    )


def unrolled_plan(plan: ExecutionPlan, k: int) -> ExecutionPlan:
    """The per-iteration plan expanded onto the concatenated k-iteration
    graph: every call keeps its assignment across iterations."""
    return ExecutionPlan(
        {f"{n}@{t}": a for n, a in plan.assignments.items()
         for t in range(k)}, plan.cluster)


def steady_state_time(dfg: DataflowGraph, plan: ExecutionPlan,
                      cost: CostModel, k: int = 3,
                      unrolled: Optional[DataflowGraph] = None) -> float:
    """Steady-state per-iteration time of the pipelined runtime: simulate the
    concatenated k-iteration graph (version edges gate trainable models;
    frozen-model calls and reallocations overlap iteration boundaries) and
    difference out the cold-start makespan — ``(T_k - T_1) / (k - 1)``.
    This is what the search should rank plans on when the runtime runs with
    ``pipeline_depth > 1``; a single-iteration makespan penalizes plans whose
    tail work (e.g. a long critic train) the pipeline would hide."""
    if k <= 1:
        return simulate(dfg, plan, cost).total_time
    t1 = simulate(dfg, plan, cost).total_time
    u = unrolled if unrolled is not None else unroll_iterations(dfg, k)
    tk = simulate(u, unrolled_plan(plan, k), cost).total_time
    return (tk - t1) / (k - 1)


def max_mem_per_device(dfg: DataflowGraph, plan: ExecutionPlan,
                       cost: CostModel) -> float:
    """MaxMem(G_p): static (opt states pinned to each trainable model's train
    mesh) + the worst concurrent active memory on any device.

    Conservative approximation: on every device, active memories of calls
    placed there never coexist (same-mesh calls serialize under Algorithm 1's
    exclusivity), so we take static + max(active)."""
    m = plan.cluster.devs_per_node
    static: dict[int, float] = {}
    active: dict[int, float] = {}
    for call in dfg.calls:
        asg = plan.assignments[call.name]
        devs = asg.mesh.devices(m)
        if call.call_type == TRAIN:
            s = cost.static_mem_per_dev(call.config, asg)
            for d in devs:
                static[d] = static.get(d, 0.0) + s
        a = cost.active_mem_per_dev(call, asg)
        for d in devs:
            active[d] = max(active.get(d, 0.0), a)
    return max((static.get(d, 0.0) + active.get(d, 0.0)
                for d in set(static) | set(active)), default=0.0)
