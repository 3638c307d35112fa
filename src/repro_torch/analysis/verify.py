"""Static execution-plan verifier (runtime-free).

A pure pass over ``(DataflowGraph, ExecutionPlan)`` returning structured
``Diagnostic``s instead of deep runtime tracebacks.  Error-level rules are
exactly the conditions that make the simulator / RuntimeEngine / deploy
fail; warn-level rules flag lost performance or degraded sharding that the
runtime survives (``parallel.sharding.sanitize_specs`` drops indivisible
axes, overlapping meshes serialize under Algorithm 1's device exclusivity).
That split is what lets ``core.search`` prune on errors with zero false
positives: any plan the search emits as feasible verifies clean.

Rule catalog with ids, severities and rationale: docs/ANALYSIS.md.

The port's copy of the JAX package's ``analysis/verify.py`` (framework-free): it
computes the same numbers, and only its import paths differ.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.core.dfg import (DataflowGraph, FunctionCall, GENERATE, TRAIN,
                            base_name, iteration_of, unroll_window)
from repro_torch.core.estimator import BF16, CostModel
from repro_torch.core.plan import Assignment, Cluster, ExecutionPlan

SEV_ERROR = "error"
SEV_WARN = "warn"


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One verifier finding.  ``call``/``model`` locate the offender."""

    severity: str  # error | warn
    rule: str
    message: str
    call: Optional[str] = None
    model: Optional[str] = None

    def __str__(self):
        where = f" [{self.call or self.model}]" if (self.call or
                                                    self.model) else ""
        return f"{self.severity}({self.rule}){where}: {self.message}"


class PlanVerificationError(RuntimeError):
    """Raised where an invalid plan must not proceed (deploy, replan,
    search entry).  Carries the structured diagnostics so callers — and
    chaos tests — see *why* instead of a deep reshard traceback."""

    def __init__(self, diagnostics: Iterable[Diagnostic], context: str = ""):
        self.diagnostics = list(diagnostics)
        head = "execution plan failed static verification"
        if context:
            head += f" ({context})"
        super().__init__(
            head + ":\n" + "\n".join(f"  {d}" for d in self.diagnostics))


def errors(diags: Iterable[Diagnostic]) -> list[Diagnostic]:
    return [d for d in diags if d.severity == SEV_ERROR]


def warnings(diags: Iterable[Diagnostic]) -> list[Diagnostic]:
    return [d for d in diags if d.severity == SEV_WARN]


# ------------------------------------------------------------- config rules

def packed_mixer_error(cfg: ModelConfig) -> Optional[str]:
    """One-line actionable message when ``cfg`` cannot run packed
    (cu_seqlens) training — recurrent mixers have no varlen path yet
    (ROADMAP item 3).  Shared by ``RLHFExperiment`` construction and the
    ``packed-recurrent`` verifier rule so the two never drift."""
    bad = sorted({s.kind for s in cfg.layers if s.kind != ATTN})
    if not bad:
        return None
    return (f"packed_training=True requires attention-only mixers, but "
            f"'{cfg.name}' has {'/'.join(bad)} layers — set "
            f"packed_training=False or choose an attention-only config")


def _spec_mixer_error(cfg: ModelConfig) -> Optional[str]:
    """Non-None when ``cfg`` cannot take part in a speculative
    draft-and-verify pair: rejection needs rollback-free caches, i.e.
    attention-only decode (mirrors ``models.spec.spec_supported`` without
    importing the model layer)."""
    if cfg.family == "encdec" or cfg.prefix_len:
        return "speculative decoding requires a decoder-only, prefix-free model"
    bad = sorted({s.kind for s in cfg.layers if s.kind != ATTN})
    if bad:
        return (f"speculative decoding requires attention-only mixers, "
                f"but '{cfg.name}' has {'/'.join(bad)} layers")
    return None


# -------------------------------------------------------------- graph rules

def verify_graph(dfg: DataflowGraph) -> list[Diagnostic]:
    """Plan-independent rules over the dataflow graph itself.  Accepts both
    per-iteration and unrolled (``name@t``) graphs."""
    out: list[Diagnostic] = []
    try:
        dfg.topo_order()
    except ValueError:
        out.append(Diagnostic(SEV_ERROR, "dfg-cycle",
                              "dataflow graph has a dependency cycle"))

    # TRAIN exactly once per model per iteration
    train_counts: dict[tuple[str, int], list[str]] = {}
    for c in dfg.calls:
        if c.call_type == TRAIN:
            key = (c.model_name, iteration_of(c.name))
            train_counts.setdefault(key, []).append(c.name)
    for (model, it), names in train_counts.items():
        if len(names) > 1:
            out.append(Diagnostic(
                SEV_ERROR, "train-once", model=model,
                message=(f"model '{model}' has {len(names)} TRAIN calls in "
                         f"iteration {it} ({', '.join(sorted(names))}); the "
                         "version-edge protocol requires exactly one")))

    # version edges gate every trained model (the static on-policy guard):
    # unroll_window only emits a version input for calls flagged trainable,
    # so a TRAIN-owning model with an unflagged call would roll forward on
    # stale weights with no dependency stopping it.
    trained = {c.model_name for c in dfg.calls if c.call_type == TRAIN}
    for c in dfg.calls:
        if c.model_name in trained and not c.trainable:
            out.append(Diagnostic(
                SEV_ERROR, "version-edge", call=c.name, model=c.model_name,
                message=(f"call '{c.name}' of trained model "
                         f"'{c.model_name}' is not flagged trainable: "
                         "version edges will not gate it across iterations "
                         "(on-policy guard lost)")))
    flagged = {c.model_name for c in dfg.calls if c.trainable}
    for model in sorted(flagged - trained):
        out.append(Diagnostic(
            SEV_WARN, "version-edge", model=model,
            message=(f"model '{model}' is flagged trainable but has no "
                     "TRAIN call; it holds optimizer state that is never "
                     "updated and no version edge can gate it")))

    # packed workloads on recurrent mixers fail at trace time; say so here
    for c in dfg.calls:
        if (c.config is not None and c.call_type == TRAIN
                and c.workload.total_tokens > 0):
            msg = packed_mixer_error(c.config)
            if msg:
                out.append(Diagnostic(SEV_ERROR, "packed-recurrent",
                                      call=c.name, model=c.model_name,
                                      message=msg))

    # speculative rollout edges: a GENERATE call feeding another GENERATE
    # call is a draft-and-verify pair (build_ppo(draft=...)'s draft_gen ->
    # actor_gen edge).  spec_generate raises at dispatch on a vocab mismatch
    # or a cache that cannot be rolled back; catch both statically.
    produced_by = {o: c for c in dfg.calls for o in c.outputs}
    for c in dfg.calls:
        if c.call_type != GENERATE or c.config is None:
            continue
        for inp in c.inputs:
            d = produced_by.get(inp)
            if (d is None or d.call_type != GENERATE or d.config is None
                    or d.name == c.name):
                continue
            for role, cfg in (("target", c), ("draft", d)):
                msg = _spec_mixer_error(cfg.config)
                if msg:
                    out.append(Diagnostic(
                        SEV_ERROR, "spec-draft", call=cfg.name,
                        model=cfg.model_name,
                        message=f"{role} of speculative pair "
                                f"'{d.name}' -> '{c.name}': {msg}"))
            if d.config.vocab_size != c.config.vocab_size:
                out.append(Diagnostic(
                    SEV_ERROR, "spec-draft", call=c.name, model=c.model_name,
                    message=(f"draft '{d.name}' vocab "
                             f"{d.config.vocab_size} != target vocab "
                             f"{c.config.vocab_size}; rejection sampling "
                             "needs a shared token space")))
    return out


# --------------------------------------------------------- assignment rules

def _mesh_alignment_issue(asg: Assignment, cluster: Cluster) -> Optional[str]:
    """Non-None when the mesh is not one of the legal shapes (k whole
    consecutive nodes, or an aligned power-of-two sub-node slice) — the
    search-space assumption that lets disjoint meshes tile the cluster."""
    mesh = asg.mesh
    m = cluster.devs_per_node
    if mesh.dev_count == m and mesh.dev_start == 0:
        return None  # whole-node rectangle
    if mesh.node_count != 1:
        return "multi-node meshes must span whole nodes"
    d = mesh.dev_count
    if d & (d - 1) or m % d:
        return f"sub-node slice of {d} devices is not a power of two dividing {m}"
    if mesh.dev_start % d:
        return f"sub-node slice offset {mesh.dev_start} is not aligned to {d}"
    return None


def check_assignment(call: FunctionCall, asg: Assignment, cluster: Cluster,
                     cost: Optional[CostModel] = None,
                     mem_cap: Optional[float] = None) -> list[Diagnostic]:
    """Per-(call, assignment) static rules — the candidate-pruning subset.

    Error-level findings here are *monotone*: a candidate flagged invalid
    cannot be part of ANY valid plan (its own mesh/strategy/memory is
    broken), so the search may drop it before costing without ever losing
    the feasible optimum.  Calls without a ModelConfig (toy graphs) skip
    every config-dependent rule.
    """
    out: list[Diagnostic] = []
    mesh, s = asg.mesh, asg.strategy

    if (mesh.node_start < 0 or mesh.dev_start < 0 or mesh.node_count < 1
            or mesh.dev_count < 1 or not mesh.fits(cluster)):
        out.append(Diagnostic(
            SEV_ERROR, "mesh-fits", call=call.name, model=call.model_name,
            message=(f"mesh {mesh} does not fit the "
                     f"{cluster.n_nodes}x{cluster.devs_per_node} cluster")))
        return out  # device sets are meaningless beyond the boundary
    issue = _mesh_alignment_issue(asg, cluster)
    if issue:
        out.append(Diagnostic(SEV_WARN, "mesh-aligned", call=call.name,
                              message=f"mesh {mesh}: {issue}"))
    if s.tp > mesh.dev_count:
        out.append(Diagnostic(
            SEV_WARN, "tp-intra-node", call=call.name,
            message=(f"tp={s.tp} spans nodes (mesh row is {mesh.dev_count} "
                     "devices); TP collectives leave the torus row")))

    cfg = call.config
    if cfg is None:
        return out

    if s.pp > cfg.num_layers:
        out.append(Diagnostic(
            SEV_ERROR, "strategy-divides", call=call.name,
            model=call.model_name,
            message=(f"pp={s.pp} exceeds the model's {cfg.num_layers} "
                     "layers: at least one pipeline stage would be empty")))
    if s.pp > 1 and s.mbs < s.pp:
        out.append(Diagnostic(
            SEV_ERROR, "strategy-divides", call=call.name,
            message=(f"mbs={s.mbs} < pp={s.pp}: the pipeline can never "
                     "fill (permanent bubble)")))
    if s.tp > 1:
        # sharding.py shards the fused q/kv/ffn dims and sanitize_specs
        # silently replicates indivisible ones — degraded, not fatal
        for label, dim in (("q_dim", cfg.q_dim), ("kv_dim", cfg.kv_dim)):
            if dim and dim % s.tp:
                out.append(Diagnostic(
                    SEV_WARN, "tp-divisibility", call=call.name,
                    message=(f"{label}={dim} is not divisible by tp={s.tp}; "
                             "sanitize_specs will replicate that axis")))
        if cfg.ffn_kind == "gated" and cfg.d_ff % s.tp:
            out.append(Diagnostic(
                SEV_WARN, "tp-divisibility", call=call.name,
                message=f"d_ff={cfg.d_ff} is not divisible by tp={s.tp}"))
        if cfg.ffn_kind == "moe" and cfg.n_experts % s.tp:
            out.append(Diagnostic(
                SEV_WARN, "tp-divisibility", call=call.name,
                message=(f"n_experts={cfg.n_experts} is not divisible by "
                         f"tp={s.tp} (expert-parallel axis)")))

    # per-call peak-memory lower bound: any plan containing this candidate
    # puts at least this much on the assignment's devices
    cap = mem_cap if mem_cap is not None else cluster.chip.hbm_bytes
    cost = cost or CostModel(cluster)
    mem = cost.active_mem_per_dev(call, asg)
    if call.call_type == TRAIN:
        mem += cost.static_mem_per_dev(cfg, asg)
    if mem >= cap:
        out.append(Diagnostic(
            SEV_ERROR, "mem-cap", call=call.name, model=call.model_name,
            message=(f"call alone needs {mem / 1e9:.2f} GB/device on "
                     f"{mesh} (cap {cap / 1e9:.2f} GB)")))
    return out


# ------------------------------------------------------------ plan memory

def _shard_bytes(cfg: ModelConfig, asg: Assignment) -> float:
    s = asg.strategy
    return cfg.param_count() * BF16 / (s.tp * s.pp)


def _plan_memory(dfg: DataflowGraph, plan: ExecutionPlan, cost: CostModel,
                 asg_of) -> tuple[float, float, int]:
    """(base_peak, realloc_peak, worst_device).

    ``base_peak`` reproduces ``simulator.max_mem_per_device`` — static
    optimizer/grad residency on every TRAIN layout plus the worst single
    active working set per device.  ``realloc_peak`` additionally carries
    the reallocation double-buffer highwater: while a model's parameters
    move between two successive layouts (including the wrap-around move
    back to its first layout for the next iteration), devices in the union
    hold the incoming *and* the surviving outgoing shard at once.
    """
    m = plan.cluster.devs_per_node
    static: dict[int, float] = {}
    active: dict[int, float] = {}
    rehigh: dict[int, float] = {}

    try:
        order = dfg.topo_order()
    except ValueError:
        order = list(dfg.calls)

    for call in order:
        if call.config is None:
            continue
        asg = asg_of(call.name)
        if asg is None:
            continue
        devs = asg.mesh.devices(m)
        if call.call_type == TRAIN:
            s = cost.static_mem_per_dev(call.config, asg)
            for d in devs:
                static[d] = static.get(d, 0.0) + s
        a = cost.active_mem_per_dev(call, asg)
        for d in devs:
            active[d] = max(active.get(d, 0.0), a)

    # realloc double-buffer walk — the param_loc chain build_augmented_graph
    # mirrors, closed into a cycle (the runtime prefetches the move back to
    # the first layout for iteration t+1)
    chains: dict[str, list[FunctionCall]] = {}
    for call in order:
        if call.config is not None and asg_of(call.name) is not None:
            chains.setdefault(call.model_name, []).append(call)
    for calls in chains.values():
        cfg = calls[0].config
        hops = list(zip(calls, calls[1:] + calls[:1]))
        for src_call, dst_call in hops:
            src, dst = asg_of(src_call.name), asg_of(dst_call.name)
            if src == dst:
                continue
            src_devs, dst_devs = src.mesh.devices(m), dst.mesh.devices(m)
            for d in src_devs | dst_devs:
                both = ((_shard_bytes(cfg, src) if d in src_devs else 0.0)
                        + (_shard_bytes(cfg, dst) if d in dst_devs else 0.0))
                rehigh[d] = max(rehigh.get(d, 0.0), both)

    base_peak, realloc_peak, worst = 0.0, 0.0, -1
    for d in set(static) | set(active) | set(rehigh):
        base = static.get(d, 0.0) + active.get(d, 0.0)
        full = static.get(d, 0.0) + max(active.get(d, 0.0),
                                        rehigh.get(d, 0.0))
        base_peak = max(base_peak, base)
        if full > realloc_peak:
            realloc_peak, worst = full, d
    return base_peak, realloc_peak, worst


# ------------------------------------------------------------- concurrency

def _may_run_concurrently(dfg: DataflowGraph) -> list[tuple[str, str]]:
    """Unordered call-name pairs with no dependency path either way."""
    order = dfg.topo_order()
    idx = {c.name: i for i, c in enumerate(order)}
    n = len(order)
    anc = [0] * n  # bitmask of ancestors (n is small: calls x window)
    for i, c in enumerate(order):
        mask = 0
        for p in dfg.parents(c):
            j = idx[p.name]
            mask |= anc[j] | (1 << j)
        anc[i] = mask
    pairs = []
    for i in range(n):
        for j in range(i + 1, n):
            if not (anc[j] >> i) & 1 and not (anc[i] >> j) & 1:
                pairs.append((order[i].name, order[j].name))
    return pairs


# ------------------------------------------------------------- entry points

def verify(dfg: DataflowGraph, plan: ExecutionPlan, *,
           cost: Optional[CostModel] = None, pipeline_depth: int = 1,
           mem_cap: Optional[float] = None) -> list[Diagnostic]:
    """Full static verification of ``plan`` against ``dfg`` on the plan's
    cluster.  Pure and runtime-free; returns all findings, worst first."""
    cluster = plan.cluster
    cost = cost or CostModel(cluster)
    cap = mem_cap if mem_cap is not None else cluster.chip.hbm_bytes
    out = verify_graph(dfg)

    def asg_of(name: str) -> Optional[Assignment]:
        a = plan.assignments.get(name)
        return a if a is not None else plan.assignments.get(base_name(name))

    known = {c.name for c in dfg.calls} | {base_name(c.name)
                                           for c in dfg.calls}
    for name in sorted(plan.assignments):
        if name not in known:
            out.append(Diagnostic(
                SEV_WARN, "stale-assignment", call=name,
                message=f"plan assigns unknown call '{name}'"))

    complete = True
    for call in dfg.calls:
        asg = asg_of(call.name)
        if asg is None:
            complete = False
            out.append(Diagnostic(
                SEV_ERROR, "missing-assignment", call=call.name,
                message=f"plan has no assignment for call '{call.name}'"))
            continue
        out.extend(check_assignment(call, asg, cluster, cost, cap))

    if complete and not any(d.rule == "mesh-fits" for d in out):
        base, full, worst = _plan_memory(dfg, plan, cost, asg_of)
        if base >= cap:
            out.append(Diagnostic(
                SEV_ERROR, "mem-cap",
                message=(f"static peak memory {base / 1e9:.2f} GB/device "
                         f"exceeds the chip's {cap / 1e9:.2f} GB "
                         f"(worst device {worst})")))
        elif full >= cap:
            out.append(Diagnostic(
                SEV_WARN, "mem-realloc",
                message=(f"reallocation double-buffer highwater "
                         f"{full / 1e9:.2f} GB/device exceeds the chip's "
                         f"{cap / 1e9:.2f} GB on device {worst}; reshards "
                         "must stream or spill")))

        # lost-parallelism report over the pipelined window
        unrolled = dfg
        if not any("@" in c.name for c in dfg.calls):
            unrolled = unroll_window(dfg, max(pipeline_depth, 1))
        try:
            pairs = _may_run_concurrently(unrolled)
        except ValueError:
            pairs = []
        seen: set[tuple[str, str]] = set()
        for a, b in pairs:
            ba, bb = base_name(a), base_name(b)
            if ba == bb:
                continue  # same call at different iterations: expected
            key = tuple(sorted((ba, bb)))
            if key in seen:
                continue
            aa, ab = asg_of(a), asg_of(b)
            if aa is not None and ab is not None \
                    and aa.mesh.overlaps(ab.mesh):
                seen.add(key)
                out.append(Diagnostic(
                    SEV_WARN, "concurrent-overlap", call=ba,
                    message=(f"'{ba}' and '{bb}' may run concurrently but "
                             "share devices; they will serialize under "
                             "device exclusivity")))

    out.sort(key=lambda d: (d.severity != SEV_ERROR, d.rule))
    return out


def assert_valid(dfg: DataflowGraph, plan: ExecutionPlan, *,
                 cost: Optional[CostModel] = None, pipeline_depth: int = 1,
                 mem_cap: Optional[float] = None,
                 context: str = "") -> list[Diagnostic]:
    """Raise ``PlanVerificationError`` on any error-level finding; return
    the full diagnostic list (warnings included) otherwise."""
    diags = verify(dfg, plan, cost=cost, pipeline_depth=pipeline_depth,
                   mem_cap=mem_cap)
    errs = errors(diags)
    if errs:
        raise PlanVerificationError(errs, context=context)
    return diags


def filter_candidates(dfg: DataflowGraph, cluster: Cluster,
                      cands: dict[str, list[Assignment]],
                      cost: Optional[CostModel] = None,
                      mem_cap: Optional[float] = None,
                      ) -> tuple[dict[str, list[Assignment]], int]:
    """Drop per-call candidates with error-level static findings before the
    search costs them.  Returns (filtered lists, number pruned).  Raises
    ``PlanVerificationError`` when a call has no valid candidate left —
    searching could only return invalid plans."""
    cost = cost or CostModel(cluster)
    pruned = 0
    out: dict[str, list[Assignment]] = {}
    for call in dfg.calls:
        lst = cands.get(call.name, [])
        kept = [a for a in lst
                if not errors(check_assignment(call, a, cluster, cost,
                                               mem_cap))]
        pruned += len(lst) - len(kept)
        if lst and not kept:
            sample = errors(check_assignment(call, lst[0], cluster, cost,
                                             mem_cap))
            raise PlanVerificationError(
                [Diagnostic(SEV_ERROR, "no-valid-candidate", call=call.name,
                            message=(f"all {len(lst)} candidate assignments "
                                     f"for '{call.name}' fail verification "
                                     f"(e.g. {sample[0].message})"))],
                context="candidate pruning")
        out[call.name] = kept
    return out, pruned
