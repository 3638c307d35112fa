"""Runtime engine (paper §6): a master worker that resolves dataflow
dependencies and dispatches model function calls to model workers, with
parameter reallocation between calls.  The port's copy of the JAX
package's ``core/runtime.py``; it differs in four places, each for torch:

  * the "workers" are logical: each owns the parameter/optimizer state of
    the models resident on its device mesh and runs the executors of its
    calls in the event loop's default thread pool.  An executor sets what
    torch keeps per thread itself (grad mode; the device from its tensors);
  * CUDA is asynchronous, so a call's end is stamped only after its
    model's device has finished the call's work (``_settle``): a
    ``CallRecord`` measures the call, not its dispatch, and
    ``recalibrate`` folds device times into the cost model;
  * parameter trees are walked with ``optim.adamw.leaves`` (the order of
    ``jax.tree.leaves``);
  * reallocation is logical only.  The engine moves assignments, and the
    cost model bills the moves, but no parameter is resharded:
    ``sharding_for`` / ``opt_sharding_for`` must be None (physical
    resharding across cards, the JAX package's ``parallel/realloc_exec``,
    is ROADMAP Queue 1 item 5's next part).  The reshard branches below
    stay as the JAX engine has them and reach ``_reshard``, which raises.

The master is an asyncio loop with per-device locks enforcing Algorithm-1
exclusivity (calls on overlapping meshes serialize; disjoint meshes
dispatch concurrently).

Pipelined multi-iteration execution (paper §4): ``run(steps=k)`` executes
the *concatenated* dataflow graph over k iterations on one persistent event
loop.  The dependency structure is the one ``dfg.unroll_iterations`` builds
— per-iteration data edges plus parameter-version edges — materialized as a
sliding window: iteration t's calls launch once iteration ``t -
pipeline_depth`` has retired, so at most ``pipeline_depth`` iterations are
in flight and *in-flight* data-pool memory stays bounded (retired pools are
returned to the caller — stream them through ``on_retire`` with
``keep_pools=False`` on long runs).  Version edges gate
trainable models (actor_gen@t+1 waits for actor_train@t — rollouts are
never generated from stale weights), while frozen-model inference
(ref/reward) and parameter reallocations overlap iteration boundaries
freely.  Each iteration owns a private data pool; pools are retired in
order, which is where checkpointing and recalibration hooks fire.  With
``pipeline_depth=1`` the window degenerates to the barriered engine and
reproduces its data pools bit-for-bit; ``run_iteration`` remains the
single-iteration (barriered) entry point.

Reallocation overlap (paper §6, Fig. 6): every model gets a *prefetch chain*
— an asyncio task that walks the model's calls in dataflow order and kicks
off the next call's reallocation the moment the previous call on that model
finishes, i.e. as soon as the model's mesh is free and before the call's
device locks are taken.  In ``run(steps=k)`` the chains span iteration
boundaries: the actor's first reallocation of iteration t+1 dispatches as
soon as actor_train@t frees the mesh, hiding under whatever iteration-t
tail work (e.g. critic_train) is still computing.  The reshard's collectives
run underneath other calls; by the time the call itself reaches
``_maybe_reallocate`` the transfer is usually done and it records a
*prefetch hit* (``CallRecord.prefetch_hit``, cross-iteration ones also in
``stats()["cross_iter_prefetch_hits"]``) with only the residual wait on the
clock.  Prefetch is byte-accurate: ``realloc_exec.prefetch_reshard``
dispatches only the sub-tree of leaves whose layout changes, and the moved
bytes plus the measured transfer time of each ``ReshardTask`` are folded
into the cost model's reallocation term (``CostModel.record_realloc``).

Fault tolerance & elasticity (core/fault.py + docs/ARCHITECTURE.md):
  * transient call failures retry under a configurable ``RetryPolicy``
    (max attempts, exponential backoff, per-call-type overrides) after
    dropping any in-flight prefetch — without folding its transfer time
    into the realloc calibration — and re-reallocating the model's
    parameters from the last good layout
  * per-call deadline = straggler-factor x estimator time (the factor comes
    from the retry policy when set, else the engine default); breaches
    invoke ``on_straggler``, and with ``speculative_redispatch`` an
    in-flight watchdog races a duplicate dispatch of the straggling call on
    an idle mesh — first finisher wins, the loser runs out in the
    background and is ignored.  Only idempotent call types
    (``speculative_types``, default INFERENCE + GENERATE) are ever
    duplicated, so first-finisher semantics cannot double-apply a TRAIN
    step or disturb the version edges
  * a *preemption notice* (``FaultInjector.notice`` / ``notify_preemption``)
    is the proactive half of elasticity: the engine keeps running, replans
    on the *same* cluster with the doomed host's meshes excluded (so no new
    call is admitted onto them), lets the ordinary prefetch-chain
    reallocation path walk every affected model's weights — and opt states —
    onto survivor meshes underneath the ongoing compute, and retires the
    host at the next safe point (an iteration retirement with no doomed
    device busy): zero aborted calls, zero checkpoint restores
    (``recoveries[].mode == "migrate"``).  A deadline that expires before
    the drain completes degrades to the reactive host-loss path below
  * a ``DeviceLostError`` (host loss) is a *topology change*, not a retry:
    the window aborts at the next safe point (in-flight executor threads
    always run to completion so completed work is never re-run), dead
    devices are masked out of the mesh via ``DeviceHealth.compact()``, the
    caller-supplied ``replanner`` searches a plan for the surviving
    cluster, live weights reshard onto it through ``parallel/realloc_exec``
    whenever any data-parallel replica of a model survives intact
    (``restore_models`` — checkpoint restore — is the fallback when every
    replica died; optimizer states are triaged and recovered the same way,
    as first-class sharded trees), and ``run()`` resumes from the last
    retired iteration,
    replaying only the calls that had not completed (the carried done-set
    keeps TRAIN steps exactly-once and the version-edge guard intact)
  * ``add_hosts(k)`` declares device *gain*; it is consumed at the next
    iteration retirement: the mesh grows and the replanner produces the
    expanded plan, weights resharding lazily on each model's next call
  * ``checkpoint_every`` saves model states through a CheckpointManager

Closed-loop calibration (paper §5.1 + docs/CALIBRATION.md): with
``recalibrate_every=N`` the engine folds its own CallRecords back into the
cost model at iteration *retirement*, refits the per-call-type scales, and
replans onto a candidate plan when the refitted estimates flip the
predicted ranking (ranked on steady-state per-iteration time when
``pipeline_depth > 1``).
"""

from __future__ import annotations

import asyncio
import dataclasses
import time
from typing import Any, Callable, Optional

import torch

from repro_torch.core import fault
from repro_torch.core.dfg import (DataflowGraph, FunctionCall, GENERATE, INFERENCE,
                            TRAIN, base_name, iteration_of,
                            unroll_iterations)
from repro_torch.core.estimator import CostModel
from repro_torch.core.plan import Assignment, ExecutionPlan, ParallelStrategy
from repro_torch.optim.adamw import leaves

PHYSICAL_RESHARD = ("physical resharding across cards (parallel/realloc_exec) is not "
                    "ported yet: ROADMAP Queue 1 item 5, the next part")


def _reshard(tree, dst, *, clone: bool = False):
    """Dispatch a reshard of ``tree`` onto the layout ``dst`` (donating, or
    a copy with ``clone``) and return its task (``tree``, ``wait()``,
    ``moved_bytes``, ``elapsed_s``), as the JAX package's
    ``realloc_exec.prefetch_reshard`` / ``clone_reshard``.  Not ported: see
    ``PHYSICAL_RESHARD``."""
    raise NotImplementedError(PHYSICAL_RESHARD)


def _leaves(tree) -> list:
    """The leaves of a parameter or optimizer tree (none for None), in the
    order of ``jax.tree.leaves``."""
    return [] if tree is None else [x for x in leaves(tree) if x is not None]


def _settle(state) -> None:
    """Wait until the device that holds ``state``'s parameters has finished
    the work queued on it (a no-op for host tensors and paramless
    models)."""
    for x in _leaves(state.params):
        if isinstance(x, torch.Tensor):
            if x.is_cuda:
                torch.cuda.synchronize(x.device)
            return


class _Aborted(Exception):
    """Internal: a call gave up because a device-loss fault is in flight
    elsewhere in the window.  Never escapes the engine."""


def _silent_wait(task):
    """Block until a ReshardTask's transfer lands (stamping its
    ``elapsed_s``), swallowing errors — timing is best-effort bookkeeping
    and the consuming call re-waits (and surfaces failures) itself."""
    try:
        task.wait()
    except Exception:  # noqa: BLE001
        pass


@dataclasses.dataclass
class ModelState:
    """A model's device-resident state, owned by its current mesh."""

    params: Any
    opt_state: Any = None
    assignment: Optional[Assignment] = None
    version: int = 0
    # in-flight prefetched reallocation:
    # (target assignment, ReshardTask, meta dict with "cross"/"sched")
    prefetch: Optional[tuple] = None
    # where the optimizer state currently lives (set by the model's TRAIN
    # calls; triaged and recovered alongside the params)
    opt_assignment: Optional[Assignment] = None


@dataclasses.dataclass
class CallRecord:
    name: str
    start: float
    end: float
    realloc_s: float
    straggled: bool = False
    retried: bool = False
    prefetch_hit: bool = False
    iteration: int = 0
    realloc_bytes: int = 0  # bytes actually moved by the partial reshard
    prefetch_cross: bool = False  # hit on a prefetch spanning iterations
    attempts: int = 1  # executions including retries (retried == attempts > 1)
    speculated: bool = False  # a duplicate was raced on an idle mesh
    spec_won: bool = False  # ... and the duplicate finished first


class RuntimeEngine:
    def __init__(self, dfg: DataflowGraph, plan: ExecutionPlan,
                 executors: dict[str, Callable], models: dict[str, ModelState],
                 *, cost_model: Optional[CostModel] = None,
                 sharding_for: Optional[Callable] = None,
                 opt_sharding_for: Optional[Callable] = None,
                 straggler_factor: float = 10.0,
                 on_straggler: Optional[Callable] = None,
                 speculative_redispatch: bool = False,
                 speculative_types: Optional[tuple] = None,
                 prefetch_realloc: bool = True,
                 pipeline_depth: int = 1,
                 recalibrate_every: int = 0,
                 plan_candidates: Optional[list[ExecutionPlan]] = None,
                 on_recalibrate: Optional[Callable] = None,
                 retry_policy: Optional[fault.RetryPolicy] = None,
                 fault_injector: Optional[fault.FaultInjector] = None,
                 health: Optional[fault.DeviceHealth] = None,
                 replanner: Optional[Callable] = None,
                 restore_models: Optional[Callable] = None,
                 max_recoveries: int = 8):
        """``executors[name](model_state, inputs: dict) -> dict`` runs one
        call; TRAIN executors mutate model_state.params/opt_state in place.
        ``sharding_for(model_name, assignment)`` -> dst sharding tree (or
        None to skip physical resharding, e.g. single-device tests).
        ``opt_sharding_for(model_name, assignment)`` is the optimizer-state
        analogue: when given, a model's opt state is resharded onto its
        TRAIN call's assignment (and triaged/recovered alongside the
        params); without it opt placement is tracked logically only.
        ``prefetch_realloc`` enables the overlapped-reallocation chains.

        ``speculative_redispatch`` arms the in-flight straggler watchdog:
        a call exceeding its deadline while an idle mesh exists races a
        duplicate dispatch there; first finisher wins and the loser runs
        out in the background, ignored.  Only call types in
        ``speculative_types`` (default INFERENCE + GENERATE — the
        idempotent ones) are ever duplicated; TRAIN keeps exactly-once.

        ``pipeline_depth`` is the default iteration window of ``run``: how
        many iterations of the concatenated graph may be in flight at once
        (1 = barriered).  Depths > 1 stay on-policy for PPO because the
        version edges always gate trainable models; only frozen-model work
        and reallocations cross the boundary.

        ``recalibrate_every=N`` (opt-in; needs ``cost_model``) closes the
        profile->estimate loop at runtime: once N new CallRecords exist at
        an iteration retirement, their measured times are folded into the
        cost model (``record_measurement`` + per-call-type ``refit``), the
        current plan is re-ranked against ``plan_candidates`` under the
        refitted estimates, and ``replan()`` fires when the predicted
        ranking flips.  ``on_recalibrate(n, switched)`` observes each pass.

        Elastic fault tolerance: ``retry_policy`` governs transient-failure
        retries (default reproduces the historical single retry);
        ``fault_injector`` (chaos testing) fires inside each call's
        executor thread; ``replanner(surviving_cluster, event) ->
        ExecutionPlan`` is consulted on topology changes (device loss or
        ``add_hosts`` gain) — without one, a ``DeviceLostError`` is fatal;
        ``restore_models(lost_names)`` restores models whose every replica
        died (checkpoint fallback); ``max_recoveries`` bounds recovery
        attempts per ``run()``.
        """
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if sharding_for is not None or opt_sharding_for is not None:
            raise NotImplementedError(PHYSICAL_RESHARD)
        self.dfg = dfg
        self.plan = plan
        self.executors = executors
        self.models = models
        self.cost = cost_model
        self.sharding_for = sharding_for
        self.opt_sharding_for = opt_sharding_for
        self.straggler_factor = straggler_factor
        self.on_straggler = on_straggler or (lambda *a: None)
        self.speculative_redispatch = speculative_redispatch
        self.speculative_types = (tuple(speculative_types)
                                  if speculative_types is not None
                                  else (INFERENCE, GENERATE))
        self.prefetch_realloc = prefetch_realloc
        self.pipeline_depth = pipeline_depth
        self.recalibrate_every = recalibrate_every
        self.plan_candidates = list(plan_candidates or [])
        self.on_recalibrate = on_recalibrate or (lambda *a: None)
        self.retry_policy = retry_policy or fault.RetryPolicy()
        self.fault_injector = fault_injector
        self.health = health
        self.replanner = replanner
        self.restore_models = restore_models
        self.max_recoveries = max_recoveries
        self.recoveries: list[dict] = []
        self.topology_events: list[fault.TopologyEvent] = []
        self.prefetch_aborted = 0  # drained without folding into the cost model
        self.aborted_calls = 0
        self.opt_state_resharded_bytes = 0
        self._pending_gain = 0
        # node -> migration bookkeeping for hosts under a preemption notice
        self._migrations: dict[int, dict] = {}
        self._spec_busy: set[int] = set()  # devices claimed by duplicates
        self._spec_tasks: list = []  # losing racers still running out
        self._notice_queue: list = []  # notify_preemption() hand-offs
        self._fault: Optional[fault.DeviceLostError] = None
        self._abort_ev: Optional[asyncio.Event] = None
        self.recalibrations = 0
        self.replans = 0
        self.iterations_done = 0
        self._iter_base = 0
        self._recorded_upto = 0  # records already folded into the cost model
        self._template = None  # cached (intra, cross) dependency structure
        self.records: list[CallRecord] = []
        self._dev_locks: dict[int, asyncio.Lock] = {}
        self._model_locks: dict[str, asyncio.Lock] = {}
        self._model_users: dict[str, int] = {}
        self._model_idle: dict[str, asyncio.Condition] = {}
        # static gate: an invalid plan must fail here, with structured
        # diagnostics, not deep inside the first reshard
        from repro_torch.analysis.verify import assert_valid
        assert_valid(dfg, plan, cost=self.cost,
                     pipeline_depth=self.pipeline_depth, context="deploy")
        self._rebuild_mesh_devs()

    # ------------------------------------------------------------ plan lookup
    def _assignment_for(self, name: str) -> Assignment:
        """Planned assignment of a call, resolving unrolled ``name@t`` names
        against the per-iteration plan (assignments repeat every iteration)."""
        asg = self.plan.assignments.get(name)
        if asg is None:
            asg = self.plan.assignments[base_name(name)]
        return asg

    def _rebuild_mesh_devs(self):
        m = self.plan.cluster.devs_per_node
        self._mesh_devs = {
            c.name: sorted(self._assignment_for(c.name).mesh.devices(m))
            for c in self.dfg.calls}

    # ------------------------------------------------------------- realloc
    def _model_call_chains(self) -> dict[str, list[FunctionCall]]:
        """Each model's calls in dataflow (topological) order — the order in
        which its parameters visit assignments within an iteration."""
        chains: dict[str, list[FunctionCall]] = {}
        for call in self.dfg.topo_order():
            chains.setdefault(call.model_name, []).append(call)
        return chains

    # -- same-model exclusion: a donating reshard must never run while an
    # -- executor of the same model is computing on the current buffers
    def _begin_use(self, model_name: str):
        self._model_users[model_name] = self._model_users.get(model_name,
                                                              0) + 1

    async def _end_use(self, model_name: str):
        self._model_users[model_name] -= 1
        cond = self._model_idle.setdefault(model_name, asyncio.Condition())
        async with cond:
            cond.notify_all()

    async def _await_model_idle(self, model_name: str):
        cond = self._model_idle.setdefault(model_name, asyncio.Condition())
        async with cond:
            await cond.wait_for(
                lambda: self._model_users.get(model_name, 0) == 0)

    def _sched_for(self, call: FunctionCall, src: Optional[Assignment],
                   dst: Assignment):
        """Fig. 6 remap schedule for this reallocation (None when there is
        no analytic reference — toy calls or an unknown source layout)."""
        if call.config is None or src is None or src == dst:
            return None
        from repro_torch.core import realloc
        try:
            return realloc.remap_schedule(call.config, src, dst,
                                          self.plan.cluster)
        except Exception:  # noqa: BLE001 — bookkeeping only, never fatal
            return None

    def _fold_realloc(self, sched, task) -> None:
        """Fold one completed ReshardTask into the cost model's reallocation
        term (moved bytes + measured transfer time vs the schedule's
        prediction).  Pure-alias reshards (0 bytes moved) are skipped."""
        if (self.cost is None or sched is None or task is None
                or task.moved_bytes <= 0 or not task.elapsed_s):
            return
        self.cost.record_realloc(sched.time, task.elapsed_s,
                                 task.moved_bytes)

    async def _drain_prefetch(self, model_name: str, *, fold: bool = False):
        """Retire a model's in-flight prefetched reallocation under the
        model lock (so it never races a dispatching prefetch chain).

        The dispatched transfer always runs to completion — its donation
        already committed ``st.params`` to the new buffers — but with
        ``fold=False`` its measured time is *excluded* from the cost
        model's realloc calibration: a transfer drained on the failure or
        abort path does not represent a planned reallocation hop, and
        folding it would poison the calibration (satellite: leaked
        prefetch ReshardTasks)."""
        lock = self._model_locks.get(model_name)
        if lock is not None:
            async with lock:
                await self._drain_prefetch_inner(model_name, fold)
        else:
            await self._drain_prefetch_inner(model_name, fold)

    async def _drain_prefetch_inner(self, model_name: str, fold: bool):
        st = self.models[model_name]
        if st.prefetch is None:
            return
        target, task, meta = st.prefetch
        st.prefetch = None
        waiter = meta.get("waiter")
        if waiter is not None:
            try:
                await waiter
            except Exception:  # noqa: BLE001 — bookkeeping-only future
                pass
        loop = asyncio.get_running_loop()
        try:
            await loop.run_in_executor(None, task.wait)
        except Exception:  # noqa: BLE001 — transfer itself failed
            st.assignment = None
            return
        st.assignment = target
        if fold:
            self._fold_realloc(meta.get("sched"), task)
        else:
            self.prefetch_aborted += 1

    def _drain_prefetch_sync(self, model_name: str):
        """Loop-less drain for the recovery path (the event loop is gone;
        its default executor was joined at shutdown, so the transfer and
        its waiter thread have already landed)."""
        st = self.models[model_name]
        if st.prefetch is None:
            return
        target, task, _meta = st.prefetch
        st.prefetch = None
        try:
            task.wait()
        except Exception:  # noqa: BLE001
            st.assignment = None
            return
        st.assignment = target
        self.prefetch_aborted += 1

    async def _prefetch_for(self, call: FunctionCall, *, cross: bool = False):
        """Dispatch the reallocation for ``call`` ahead of its execution.

        Runs with the model lock held so it never races the synchronous
        path in ``_maybe_reallocate``; the actual transfer proceeds in the
        background after dispatch (JAX arrays are futures).  ``cross`` marks
        a prefetch whose trigger (the model's previous call) completed in an
        earlier iteration — the cross-iteration overlap of the pipelined
        runtime."""
        st = self.models[call.model_name]
        target = self._assignment_for(call.name)
        if st.assignment == target or self.sharding_for is None:
            return
        async with self._model_locks[call.model_name]:
            if st.assignment == target or st.prefetch is not None:
                return
            dst = self.sharding_for(call.model_name, target)
            if dst is None:
                return
            sched = self._sched_for(call, st.assignment, target)
            await self._await_model_idle(call.model_name)
            loop = asyncio.get_running_loop()
            params = st.params

            def dispatch():
                task = _reshard(params, dst)
                # commit in-thread, atomically with the donation: even if
                # the awaiting chain is cancelled mid-await, st.params
                # never dangles on donated buffers
                st.params = task.tree
                return task

            task = await loop.run_in_executor(None, dispatch)
            # a background waiter stamps task.elapsed_s at *transfer*
            # completion — the consuming call may arrive much later, and
            # its residual wait must not masquerade as transfer time in
            # the realloc calibration
            waiter = loop.run_in_executor(None, _silent_wait, task)
            st.prefetch = (target, task,
                           {"cross": cross, "sched": sched,
                            "waiter": waiter})

    async def _prefetch_chain(self, calls: list[FunctionCall], steps: int,
                              done: dict[str, asyncio.Event],
                              admitted: list[asyncio.Event]):
        """Walk one model's calls in order across the whole run; prefetch
        each call's realloc as soon as the model's previous call — possibly
        in the previous iteration — has released its mesh."""
        prev = None  # (call name, iteration)
        for t in range(steps):
            await admitted[t].wait()
            for call in calls:
                if done[f"{call.name}@{t}"].is_set():
                    # already completed (replay after a recovery): no
                    # reallocation to prefetch, fast-forward the chain
                    prev = (call.name, t)
                    continue
                if prev is not None:
                    await done[f"{prev[0]}@{prev[1]}"].wait()
                try:
                    await self._prefetch_for(
                        call, cross=prev is not None and prev[1] < t)
                except Exception:  # noqa: BLE001 — best-effort; sync path redoes it
                    pass
                prev = (call.name, t)

    async def _maybe_reallocate(
            self, call: FunctionCall) -> tuple[float, bool, bool, int]:
        """Move the call's model to its planned assignment.  Returns
        (seconds on the critical path, prefetch_hit, cross-iteration hit,
        bytes moved on the critical path)."""
        st = self.models[call.model_name]
        target = self._assignment_for(call.name)
        if st.assignment == target:
            return 0.0, False, False, 0
        async with self._model_locks.setdefault(call.model_name,
                                                asyncio.Lock()):
            t0 = time.monotonic()
            loop = asyncio.get_running_loop()
            if st.prefetch is not None:
                pf_target, pf_task, pf_meta = st.prefetch
                st.prefetch = None
                waiter = pf_meta.get("waiter")
                if pf_target == target:
                    # only the residual wait is on the critical path
                    if waiter is not None:
                        await waiter
                    await loop.run_in_executor(None, pf_task.wait)
                    st.assignment = target
                    self._fold_realloc(pf_meta.get("sched"), pf_task)
                    return (time.monotonic() - t0, True,
                            bool(pf_meta.get("cross")), pf_task.moved_bytes)
                # mismatched prefetch (e.g. a replan changed the target):
                # the dispatched reshard already moved st.params to the
                # prefetched layout, so that is the true source of the
                # fresh reshard below; drain it first so the fresh
                # reshard's measured time covers only its own hop
                if waiter is not None:
                    await waiter
                st.assignment = pf_target
            moved = 0
            if self.sharding_for is not None:
                dst = self.sharding_for(call.model_name, target)
                if dst is not None:
                    await self._await_model_idle(call.model_name)
                    sched = self._sched_for(call, st.assignment, target)
                    params = st.params

                    def dispatch():
                        task = _reshard(params, dst)
                        st.params = task.tree
                        return task

                    task = await loop.run_in_executor(None, dispatch)
                    await loop.run_in_executor(None, task.wait)
                    self._fold_realloc(sched, task)
                    moved = task.moved_bytes
            st.assignment = target
            return time.monotonic() - t0, False, False, moved

    async def _maybe_reallocate_opt(self, call: FunctionCall) -> int:
        """Move the call's optimizer state to the call's assignment (TRAIN
        only).  Separate from ``_maybe_reallocate`` because that path
        early-returns when the *params* are already placed — and a prefetch
        hit bypasses its dispatch entirely — while the opt state has its own
        placement lifecycle.  Returns bytes moved on the critical path."""
        if call.call_type != TRAIN:
            return 0
        st = self.models[call.model_name]
        if st.opt_state is None:
            return 0
        target = self._assignment_for(call.name)
        if st.opt_assignment == target:
            return 0
        async with self._model_locks.setdefault(call.model_name,
                                                asyncio.Lock()):
            if st.opt_assignment == target:
                return 0
            moved = 0
            if self.opt_sharding_for is not None:
                dst = self.opt_sharding_for(call.model_name, target)
                if dst is not None:
                    await self._await_model_idle(call.model_name)
                    loop = asyncio.get_running_loop()
                    opt = st.opt_state

                    def dispatch():
                        task = _reshard(opt, dst)
                        st.opt_state = task.tree
                        return task

                    task = await loop.run_in_executor(None, dispatch)
                    await loop.run_in_executor(None, task.wait)
                    moved = task.moved_bytes
                    self.opt_state_resharded_bytes += moved
            # tracked logically even without physical resharding, so the
            # recovery triage knows which mesh the opt state lives on
            st.opt_assignment = target
            return moved

    # ------------------------------------------------ preemption migration
    def notify_preemption(self, node: int, deadline_s: float):
        """External preemption notice: host ``node`` will be reclaimed in
        ``deadline_s`` seconds.  Consumed at the engine's next poll point;
        the engine then drains and migrates instead of crashing."""
        self._notice_queue.append(
            fault.PreemptionNotice(node, deadline_s, time.monotonic()))

    def _take_notices(self) -> list:
        notes, self._notice_queue = list(self._notice_queue), []
        if self.fault_injector is not None:
            notes.extend(self.fault_injector.take_notices())
        return notes

    async def _poll_preemptions(self):
        """Pick up newly delivered preemption notices and enforce the
        deadlines of in-progress migrations (expiry degrades to the
        reactive host-loss path via ``DeviceLostError``)."""
        for note in self._take_notices():
            await self._begin_migration(note)
        self._check_doomed()

    def _check_doomed(self):
        now = time.monotonic()
        expired = sorted(n for n, mig in self._migrations.items()
                         if now > mig["deadline"])
        if expired:
            raise fault.DeviceLostError(
                nodes=tuple(expired),
                message=f"preemption deadline expired on host(s) {expired}")

    async def _begin_migration(self, note):
        """Start draining a noticed host: mark it doomed, replan on the
        *same* cluster with its meshes excluded (no renumbering while
        in-flight calls hold coordinate-bound locks), and drop any prefetch
        targeting it.  Live weights then walk onto survivor meshes through
        the ordinary reallocation path while compute continues."""
        node = note.node
        if node in self._migrations:
            return
        if self.health is None:
            self.health = fault.DeviceHealth(self.plan.cluster)
        if (node in self.health.dead_nodes
                or node in self.health.retired_nodes):
            return
        t0 = time.monotonic()
        event = self.health.notice(node, note.deadline_s)
        self.topology_events.append(event)
        mig = {"deadline": (note.at or t0) + note.deadline_s, "t0": t0,
               "event": event, "replan_s": 0.0}
        self._migrations[node] = mig
        if self.replanner is not None:
            tr = time.monotonic()
            new_plan = self.replanner(self.plan.cluster, event)
            mig["replan_s"] = time.monotonic() - tr
            self.replan(new_plan)
        # a prefetch dispatched toward the doomed host is dead weight:
        # drain it (excluded from the realloc calibration) so the sync
        # path reshards onto the survivor plan instead
        doomed = self.health.doomed_devices()
        m = self.plan.cluster.devs_per_node
        for name, st in self.models.items():
            pf = st.prefetch
            if pf is not None and (pf[0].mesh.devices(m) & doomed):
                await self._drain_prefetch(name, fold=False)

    async def _finalize_migration(self):
        """Retire drained hosts at a safe point (an iteration retirement
        with no doomed device busy).  Any model whose params or opt state
        still sit on a doomed mesh is force-resharded onto the survivor
        plan first — so retirement never strands live state — then the
        host leaves the health roster without renumbering and a
        ``mode == "migrate"`` recovery record is written: zero aborted
        calls, zero checkpoint restores."""
        if not self._migrations or self.health is None:
            return
        doomed = self.health.doomed_devices()
        m = self.plan.cluster.devs_per_node
        # safe point: no in-flight call may hold a doomed device
        for d in doomed:
            lk = self._dev_locks.get(d)
            if lk is not None and lk.locked():
                return
        t0 = time.monotonic()
        moved = 0
        for model_name, calls in self._model_call_chains().items():
            st = self.models.get(model_name)
            if st is None or not calls:
                continue
            on_doomed = (
                (st.assignment is not None
                 and st.assignment.mesh.devices(m) & doomed)
                or (st.opt_assignment is not None
                    and st.opt_assignment.mesh.devices(m) & doomed))
            if not on_doomed:
                continue
            await self._drain_prefetch(model_name, fold=False)
            async with self._model_locks.setdefault(model_name,
                                                    asyncio.Lock()):
                await self._await_model_idle(model_name)
                loop = asyncio.get_running_loop()
                target = self._assignment_for(calls[0].name)
                if (st.assignment is not None
                        and st.assignment.mesh.devices(m) & doomed
                        and _leaves(st.params)):
                    dst = (self.sharding_for(model_name, target)
                           if self.sharding_for is not None else None)
                    if dst is not None:
                        params = st.params

                        def dispatch():
                            task = _reshard(params, dst)
                            st.params = task.tree
                            return task

                        task = await loop.run_in_executor(None, dispatch)
                        await loop.run_in_executor(None, task.wait)
                        moved += task.moved_bytes
                    st.assignment = target
                if (st.opt_assignment is not None
                        and st.opt_assignment.mesh.devices(m) & doomed):
                    train = [c for c in calls if c.call_type == TRAIN]
                    opt_target = (self._assignment_for(train[0].name)
                                  if train else target)
                    dst = (self.opt_sharding_for(model_name, opt_target)
                           if self.opt_sharding_for is not None else None)
                    if dst is not None and st.opt_state is not None:
                        opt = st.opt_state

                        def dispatch_opt():
                            task = _reshard(opt, dst)
                            st.opt_state = task.tree
                            return task

                        task = await loop.run_in_executor(None, dispatch_opt)
                        await loop.run_in_executor(None, task.wait)
                        moved += task.moved_bytes
                        self.opt_state_resharded_bytes += task.moved_bytes
                    st.opt_assignment = opt_target
        reshard_s = time.monotonic() - t0
        now = time.monotonic()
        for node in sorted(self._migrations):
            mig = self._migrations.pop(node)
            ev = self.health.retire_host(node)
            self.topology_events.append(ev)
            self.recoveries.append({
                "mode": "migrate",
                "dead_nodes": [node],
                "lost_models": [],
                "resumed_iteration": self.iterations_done,
                "surviving_devices": self.plan.cluster.size
                - len(self.health.dead_devices())
                - len(self.health.doomed_devices()),
                "drain_s": now - mig["t0"],
                "replan_s": mig["replan_s"],
                "restore_s": 0.0,
                "reshard_s": reshard_s,
                "moved_bytes": moved,
                # recovery *work* only — the drain overlaps live compute
                "total_s": mig["replan_s"] + reshard_s,
            })

    # ------------------------------------------- speculative re-dispatch
    def _idle_assignment(self, call: FunctionCall) -> Optional[Assignment]:
        """Largest legal mesh with every device idle — unlocked, healthy,
        not doomed/retired, not already claimed by another duplicate, and
        disjoint from the straggling call's own mesh.  None when the
        cluster has no spare capacity to race on."""
        m = self.plan.cluster.devs_per_node
        bad = set(self._spec_busy)
        bad.update(self._mesh_devs[call.name])
        if self.health is not None:
            bad.update(self.health.dead_devices())
            bad.update(self.health.doomed_devices())
            for n in self.health.retired_nodes:
                bad.update(range(n * m, (n + 1) * m))
        best = None
        for mesh in self.plan.cluster.legal_meshes():
            devs = mesh.devices(m)
            if devs & bad:
                continue
            if any(self._dev_locks.get(d) is not None
                   and self._dev_locks[d].locked() for d in devs):
                continue
            if best is None or mesh.size > best.size:
                best = mesh
        if best is None:
            return None
        return Assignment(best, ParallelStrategy(best.size, 1, 1, 1))

    async def _run_duplicate(self, call: FunctionCall, fn, inputs,
                             spec_asg: Assignment):
        """Execute the duplicate on the idle mesh.  The primary is still
        computing on the source buffers, so the params are *cloned*
        (non-donating reshard) onto the spare mesh; the duplicate never
        takes device locks — the ``_spec_busy`` claim plus the idle scan
        keep it off every planned mesh — and skips the fault injector
        (faults are scripted against primary executions)."""
        m = self.plan.cluster.devs_per_node
        devs = spec_asg.mesh.devices(m)
        self._spec_busy |= devs
        try:
            st = self.models[call.model_name]
            loop = asyncio.get_running_loop()
            params = st.params
            if self.sharding_for is not None:
                dst = self.sharding_for(call.model_name, spec_asg)
                if dst is not None:
                    params = await loop.run_in_executor(
                        None, lambda: _reshard(st.params, dst, clone=True).tree)
            dup_ms = dataclasses.replace(st, params=params,
                                         assignment=spec_asg,
                                         prefetch=None)
            self._begin_use(call.model_name)
            try:
                def work():
                    out = fn(dup_ms, inputs)
                    _settle(dup_ms)
                    return out
                return await loop.run_in_executor(None, work)
            finally:
                await self._end_use(call.model_name)
        finally:
            self._spec_busy -= devs

    def _reap_loser(self, task: asyncio.Task):
        """Let the losing racer run out in the background and swallow its
        result.  A device loss inside the loser still matters — it is a
        topology change — so only that escalates."""
        self._spec_tasks.append(task)

        def _done(tk: asyncio.Task):
            if tk.cancelled():
                return
            err = tk.exception()
            if isinstance(err, fault.DeviceLostError):
                self.aborted_calls += 1
                self._signal_fault(err)

        task.add_done_callback(_done)

    async def _execute_speculative(self, call: FunctionCall, execute,
                                   fn, inputs, deadline, spec: dict):
        """Race a duplicate dispatch against a straggling primary.  The
        watchdog arms at the call's deadline; past it, if an idle mesh
        exists, the duplicate launches there and the first clean finisher
        wins.  Restricted to idempotent call types — a re-run returns the
        same outputs and mutates nothing — so first-finisher semantics
        cannot double-apply state."""
        if (not self.speculative_redispatch or deadline is None
                or call.call_type not in self.speculative_types):
            return await execute()
        primary = asyncio.ensure_future(execute())
        try:
            done, _ = await asyncio.wait({primary}, timeout=deadline)
            if done:
                return primary.result()
            spec_asg = self._idle_assignment(call)
            if spec_asg is None:
                return await primary
            dup = asyncio.ensure_future(
                self._run_duplicate(call, fn, inputs, spec_asg))
            spec["dispatched"] = True
        except asyncio.CancelledError:
            primary.cancel()
            raise
        try:
            await asyncio.wait({primary, dup},
                               return_when=asyncio.FIRST_COMPLETED)
            if primary.done():
                # primary preferred on a tie: its outputs are the ones the
                # deterministic no-speculation schedule would have produced
                self._reap_loser(dup)
                return primary.result()
            if dup.exception() is None:
                spec["won"] = True
                self._reap_loser(primary)
                return dup.result()
            # duplicate errored: fall back to the primary
            return await primary
        except asyncio.CancelledError:
            primary.cancel()
            dup.cancel()
            raise

    # ------------------------------------------------------------- dispatch
    async def _locks_for(self, name: str):
        locks = []
        for d in self._mesh_devs[name]:
            if d not in self._dev_locks:
                self._dev_locks[d] = asyncio.Lock()
            locks.append(self._dev_locks[d])
        return locks

    def _check_abort(self):
        if self._fault is not None:
            raise _Aborted()

    def _signal_fault(self, err: BaseException):
        """First escalating fault wins; wake every dependency waiter so the
        window drains instead of deadlocking on done-events that will never
        be set.  Device-loss faults trigger recovery in ``run()``; any
        other escalated failure surfaces to the caller after the drain."""
        if self._fault is None:
            self._fault = err
        if self._abort_ev is not None:
            self._abort_ev.set()

    async def _wait_dep(self, ev: asyncio.Event):
        """Wait on a dependency event, racing the abort signal: a call
        whose parent died must unblock and stand down, not wait forever."""
        if ev.is_set():
            return
        if self._abort_ev is None:
            await ev.wait()
            return
        self._check_abort()
        w = asyncio.ensure_future(ev.wait())
        ab = asyncio.ensure_future(self._abort_ev.wait())
        try:
            await asyncio.wait({w, ab},
                               return_when=asyncio.FIRST_COMPLETED)
        finally:
            for f in (w, ab):
                if not f.done():
                    f.cancel()
        if not ev.is_set():
            raise _Aborted()

    async def _run_call(self, call: FunctionCall, t: int,
                        pools: dict[int, dict],
                        done: dict[str, asyncio.Event],
                        intra: dict[str, list[str]],
                        cross: dict[str, list[str]],
                        done_keys: Optional[set] = None):
        try:
            await self._run_call_inner(call, t, pools, done, intra, cross,
                                       done_keys)
        except (_Aborted, asyncio.CancelledError):
            raise
        except BaseException as err:
            # any escalating failure aborts the window: siblings blocked on
            # this call's done-event must wake and stand down, not hang the
            # (all-siblings-awaited) iteration gather
            self._signal_fault(err)
            raise

    async def _run_call_inner(self, call: FunctionCall, t: int,
                              pools: dict[int, dict],
                              done: dict[str, asyncio.Event],
                              intra: dict[str, list[str]],
                              cross: dict[str, list[str]],
                              done_keys: Optional[set] = None):
        # preemption notices are consumed before the call binds to a mesh:
        # a replan here keeps new admissions off the doomed host
        await self._poll_preemptions()
        for p in intra[call.name]:
            await self._wait_dep(done[f"{p}@{t}"])
        if t > 0:  # version edges into the previous iteration
            for p in cross[call.name]:
                await self._wait_dep(done[f"{p}@{t - 1}"])
        data = pools[t]
        locks = await self._locks_for(call.name)
        for lk in locks:  # deterministic (device-id) order: no deadlock
            await lk.acquire()
        try:
            self._check_abort()
            realloc_s, prefetch_hit, cross_hit, moved = \
                await self._maybe_reallocate(call)
            moved += await self._maybe_reallocate_opt(call)
            self._check_abort()
            policy = self.retry_policy.for_call_type(call.call_type)
            factor = (policy.straggler_factor
                      if policy.straggler_factor is not None
                      else self.straggler_factor)
            deadline = None
            if self.cost is not None:
                deadline = factor * self.cost.call_time(
                    call, self._assignment_for(call.name))
            t0 = time.monotonic()
            inputs = {k: data[k] for k in call.inputs if k in data}
            loop = asyncio.get_running_loop()

            fn = self.executors.get(call.name) \
                or self.executors[base_name(call.name)]
            abs_iter = self._iter_base + t

            def work():
                # chaos injection fires in the executor thread, exactly
                # where a real device fault would surface
                if self.fault_injector is not None:
                    self.fault_injector.on_execute(call.name, abs_iter)
                state = self.models[call.model_name]
                out = fn(state, inputs)
                _settle(state)
                return out

            async def execute():
                self._begin_use(call.model_name)
                try:
                    return await loop.run_in_executor(None, work)
                finally:
                    await self._end_use(call.model_name)

            attempts = 0
            spec = {"dispatched": False, "won": False}
            while True:
                attempts += 1
                try:
                    out = await self._execute_speculative(
                        call, execute, fn, inputs, deadline, spec)
                    break
                except fault.DeviceLostError as err:
                    # topology change, not a retryable failure: escalate
                    self.aborted_calls += 1
                    self._signal_fault(err)
                    raise
                except asyncio.CancelledError:
                    raise
                except Exception:  # noqa: BLE001 — transient under policy
                    if attempts >= policy.max_attempts:
                        raise
                    self._check_abort()
                    # drop (never fold) any in-flight prefetch, then force
                    # a fresh reallocation from the last good layout
                    await self._drain_prefetch(call.model_name, fold=False)
                    self.models[call.model_name].assignment = None
                    backoff = policy.backoff_for(attempts)
                    if backoff > 0:
                        await asyncio.sleep(backoff)
                    await self._maybe_reallocate(call)
            retried = attempts > 1
            t1 = time.monotonic()
            straggled = (spec["dispatched"]
                         or (deadline is not None and (t1 - t0) > deadline))
            if straggled:
                self.on_straggler(call.name, t1 - t0, deadline)
            if call.call_type == TRAIN:
                self.models[call.model_name].version += 1
            data.update(out or {})
            self.records.append(CallRecord(
                call.name, t0, t1, realloc_s, straggled, retried,
                prefetch_hit, iteration=self._iter_base + t,
                realloc_bytes=moved, prefetch_cross=cross_hit,
                attempts=attempts, speculated=spec["dispatched"],
                spec_won=spec["won"]))
        finally:
            for lk in reversed(locks):
                lk.release()
        done[f"{call.name}@{t}"].set()
        if done_keys is not None:
            done_keys.add(f"{call.name}@{t}")

    # ------------------------------------------------- pipelined scheduling
    def _dependency_template(self) -> tuple[dict, dict]:
        """Per-call dependency structure of the concatenated graph, derived
        from ``dfg.unroll_iterations`` so the runtime and the simulator agree
        on the edges: ``intra[name]`` are same-iteration parents, and
        ``cross[name]`` the previous-iteration parents (the parameter-version
        edges that keep trainable models on-policy)."""
        if self._template is None:
            intra: dict[str, list[str]] = {}
            cross: dict[str, list[str]] = {}
            if any("@" in c.name for c in self.dfg.calls):
                # already-unrolled graph: run it flat as one "iteration"
                for c in self.dfg.calls:
                    intra[c.name] = [p.name for p in self.dfg.parents(c)]
                    cross[c.name] = []
            else:
                g2 = unroll_iterations(self.dfg, 2)
                for c in self.dfg.calls:
                    parents = g2.parents(g2.by_name[f"{c.name}@1"])
                    intra[c.name] = [base_name(p.name) for p in parents
                                     if iteration_of(p.name) == 1]
                    cross[c.name] = [base_name(p.name) for p in parents
                                     if iteration_of(p.name) == 0]
            self._template = (intra, cross)
        return self._template

    async def _run_pipelined(self, steps: int, depth: int, data_for,
                             on_retire, keep_pools: bool,
                             quiesce_on_retire: bool,
                             carry: dict, results: list) -> list:
        """One attempt at the window.  ``carry`` survives recovery attempts
        within a ``run()``: the retired-iteration count, the per-iteration
        data pools still in flight, and the set of completed call keys
        (``name@t``).  On replay after a device-loss recovery, completed
        calls are skipped — their outputs are already in the carried pools
        — so TRAIN steps apply exactly once and rollouts are never
        regenerated from advanced weights."""
        intra, cross = self._dependency_template()
        done: dict[str, asyncio.Event] = {}
        pools: dict[int, dict] = carry["pools"]
        done_keys: set = carry["done"]
        start = carry["retired"]
        admitted = [asyncio.Event() for _ in range(steps)]
        retire_cond = asyncio.Condition()
        state = {"retired": start, "failed": False}
        self._fault = None
        self._abort_ev = asyncio.Event()

        async def run_iter(t: int):
            try:
                res = await asyncio.gather(*(
                    self._run_call(c, t, pools, done, intra, cross,
                                   done_keys)
                    for c in self.dfg.calls
                    if f"{c.name}@{t}" not in done_keys),
                    return_exceptions=True)
                # return_exceptions: every sibling call coroutine has
                # finished (completed, failed, or stood down) before the
                # iteration concludes — nothing runs detached into a
                # recovery, so weights never move under a live executor
                errs = [r for r in res if isinstance(r, BaseException)]
                real = [e for e in errs if not isinstance(e, _Aborted)]
                if real:
                    raise real[0]
                if errs:
                    raise errs[0]
                # retire strictly in iteration order: pools hand back, then
                # checkpoint/recalibration observe a consistent prefix
                async with retire_cond:
                    await retire_cond.wait_for(
                        lambda: state["failed"] or state["retired"] == t)
                    if state["failed"]:
                        return
                    # safe point: retire drained (preemption-noticed) hosts
                    # BEFORE the pool pops — a deadline expiry raised here
                    # replays this retirement cleanly after recovery
                    await self._poll_preemptions()
                    await self._finalize_migration()
                    pool = pools.pop(t)
                    if keep_pools:
                        results[t] = pool
                    self.iterations_done += 1
                    if on_retire is not None:
                        if quiesce_on_retire:
                            # drain running executors first: a hook that
                            # snapshots model state (checkpointing) must
                            # never read buffers a concurrent train step
                            # donated.  The hook itself runs synchronously
                            # in the loop thread, so no new call can start
                            # underneath it.
                            for m in self.models:
                                await self._await_model_idle(m)
                        on_retire(self._iter_base + t, pool)
                    if (self.recalibrate_every > 0 and self.cost is not None
                            and len(self.records) - self._recorded_upto
                            >= self.recalibrate_every):
                        self.recalibrate()
                    if self._pending_gain and self.replanner is not None:
                        # device gain is consumed at retirement: grow the
                        # mesh and replan; weights reshard lazily on each
                        # model's next call
                        self._apply_gain()
                    state["retired"] = t + 1
                    carry["retired"] = t + 1
                    retire_cond.notify_all()
            except BaseException:
                # wake the admission loop and sibling retirements so the
                # failure propagates instead of deadlocking the window
                async with retire_cond:
                    state["failed"] = True
                    retire_cond.notify_all()
                raise

        prefetchers = []
        if self.prefetch_realloc and self.sharding_for is not None:
            prefetchers = [
                asyncio.create_task(
                    self._prefetch_chain(calls, steps, done, admitted))
                for calls in self._model_call_chains().values()]
        iter_tasks: list[asyncio.Task] = []
        try:
            for t in range(steps):
                if t < start:
                    # retired in a previous attempt: materialize its done
                    # events pre-set so carried version edges and prefetch
                    # chains resolve instantly
                    for c in self.dfg.calls:
                        ev = asyncio.Event()
                        ev.set()
                        done[f"{c.name}@{t}"] = ev
                    admitted[t].set()
                    continue
                # sliding window: admit t once t - depth has retired
                async with retire_cond:
                    await retire_cond.wait_for(
                        lambda: state["failed"]
                        or state["retired"] >= t - (depth - 1))
                    if state["failed"]:
                        break
                if t not in pools:
                    pools[t] = dict(data_for(t))
                for c in self.dfg.calls:
                    ev = asyncio.Event()
                    if f"{c.name}@{t}" in done_keys:
                        ev.set()
                    done[f"{c.name}@{t}"] = ev
                admitted[t].set()
                iter_tasks.append(asyncio.create_task(run_iter(t)))
            res = await asyncio.gather(*iter_tasks, return_exceptions=True)
            if self._fault is not None:
                raise self._fault
            real = [r for r in res if isinstance(r, BaseException)
                    and not isinstance(r, (_Aborted,
                                           asyncio.CancelledError))]
            if real:
                raise real[0]
        finally:
            for tk in prefetchers:
                tk.cancel()
            for tk in iter_tasks:
                if not tk.done():
                    tk.cancel()
            await asyncio.gather(*prefetchers, *iter_tasks,
                                 return_exceptions=True)
            # losing speculative racers run out before the loop (and its
            # executor) tears down — their threads must not outlive it
            spec_tasks, self._spec_tasks = self._spec_tasks, []
            await asyncio.gather(*spec_tasks, return_exceptions=True)
            if self._fault is not None:
                # abort path: drain every in-flight prefetch now, while
                # the loop's executor is still alive, and keep their
                # transfer times out of the realloc calibration
                for name in self.models:
                    await self._drain_prefetch(name, fold=False)
        return results

    def run(self, initial_data, steps: int = 1, *,
            pipeline_depth: Optional[int] = None,
            on_retire: Optional[Callable[[int, dict], None]] = None,
            keep_pools: bool = True,
            quiesce_on_retire: bool = False) -> list:
        """Execute ``steps`` iterations of the concatenated dataflow graph on
        one persistent event loop and return the per-iteration data pools in
        order.

        ``initial_data`` seeds each iteration's private pool: a callable
        ``t -> dict``, a list of ``steps`` dicts, or a single dict template
        (shallow-copied per iteration).  ``pipeline_depth`` (default: the
        engine's) bounds the iterations in flight; depth 1 reproduces the
        barriered per-iteration engine bit-for-bit.  ``on_retire(t, pool)``
        fires as each iteration retires (in order) — the hook point for
        checkpointing under pipelining.  The window bounds *in-flight* pool
        memory; retired pools accumulate in the returned list, so long runs
        should consume them via ``on_retire`` and pass ``keep_pools=False``
        (the result is then a list of Nones).  ``quiesce_on_retire`` drains
        running executors before each ``on_retire`` call — required when the
        hook snapshots model state (donating train steps delete the buffers
        they consume), at the cost of a pipeline stall per retirement.
        """
        depth = (pipeline_depth if pipeline_depth is not None
                 else self.pipeline_depth)
        if depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if steps > 1 and any("@" in c.name for c in self.dfg.calls):
            raise ValueError(
                "run(steps=k) unrolls the per-iteration graph itself; "
                "construct the engine with the base dfg, not an unrolled one")
        if callable(initial_data):
            data_for = initial_data
        elif isinstance(initial_data, (list, tuple)):
            if len(initial_data) != steps:
                raise ValueError(
                    f"got {len(initial_data)} data pools for {steps} steps")
            seq = list(initial_data)
            data_for = seq.__getitem__
        else:
            template = initial_data
            data_for = lambda t: template  # noqa: E731 — copied by the runner
        carry = {"pools": {}, "done": set(), "retired": 0}
        results: list = [None] * steps
        base = self.iterations_done  # anchor: stable across recovery attempts
        attempts = 0
        while True:
            self._dev_locks = {}  # locks bind to the event loop of each run
            self._model_locks = {m: asyncio.Lock() for m in self.models}
            self._model_users = {m: 0 for m in self.models}
            self._model_idle = {}
            self._iter_base = base
            try:
                return asyncio.run(
                    self._run_pipelined(steps, depth, data_for, on_retire,
                                        keep_pools, quiesce_on_retire,
                                        carry, results))
            except fault.DeviceLostError as err:
                attempts += 1
                if self.replanner is None or attempts > self.max_recoveries:
                    raise
                self._recover(err, carry["retired"])

    def run_iteration(self, initial_data: dict) -> dict:
        """Execute one full dataflow-graph iteration (barriered: the event
        loop and any in-flight prefetch chains are torn down at return);
        returns the data pool."""
        return self.run(initial_data, steps=1, pipeline_depth=1)[0]

    # --------------------------------------------------------- recalibration
    def recalibrate(self) -> bool:
        """Fold unconsumed CallRecords into the cost model, refit its
        per-call-type scales, and replan if a candidate plan now ranks ahead
        of the current one.  Returns True when a plan switch happened.

        Records are resolved by *base* call name, so ``name@t`` records from
        an unrolled graph aggregate with (and calibrate) their per-iteration
        call.  Retried records are excluded — their span covers the failed
        attempt plus re-reallocation, not the call.  Straggled records stay:
        the flag is relative to the (possibly uncalibrated) current
        estimate, and the median refit tolerates genuine outliers.
        """
        for r in self.records[self._recorded_upto:]:
            if r.retried:
                continue
            call = (self.dfg.by_name.get(r.name)
                    or self.dfg.by_name.get(base_name(r.name)))
            if call is None:
                continue
            asg = (self.plan.assignments.get(r.name)
                   or self.plan.assignments.get(base_name(r.name)))
            if asg is None:
                continue
            self.cost.record_measurement(call, asg, r.end - r.start)
        self._recorded_upto = len(self.records)
        self.cost.refit()
        self.recalibrations += 1
        switched = self._maybe_replan()
        self.on_recalibrate(self.recalibrations, switched)
        return switched

    def _maybe_replan(self) -> bool:
        """Re-rank current plan vs candidates under the refitted estimates;
        adopt a candidate only when it is strictly better (a ranking flip).
        Pipelined engines rank on steady-state per-iteration time; the
        unrolled graph is built once and shared across all candidates."""
        if not self.plan_candidates:
            return False
        from repro_torch.core.simulator import simulate, steady_state_time
        k = self.pipeline_depth + 1
        unrolled = (unroll_iterations(self.dfg, k)
                    if self.pipeline_depth > 1 and not any(
                        "@" in c.name for c in self.dfg.calls) else None)

        def metric(plan):
            if unrolled is not None:
                return steady_state_time(self.dfg, plan, self.cost, k,
                                         unrolled=unrolled)
            return simulate(self.dfg, plan, self.cost).total_time

        cur_t = metric(self.plan)
        best, best_t = None, cur_t
        for cand in self.plan_candidates:
            t = metric(cand)
            if t < best_t:
                best, best_t = cand, t
        if best is None:
            return False
        self.replans += 1
        self.replan(best)
        return True

    # ------------------------------------------------------------ elasticity
    def replan(self, new_plan: ExecutionPlan):
        """Adopt a new execution plan (elastic resize / failed-node mask).
        Parameters physically move on the next call via reallocation.

        Every elastic path (host-loss recovery, gain, preemption-notice
        migration, recalibration swap) routes through here, so plans built
        under duress are verified before adoption — a broken replanner
        surfaces a ``PlanVerificationError`` instead of a reshard crash."""
        from repro_torch.analysis.verify import assert_valid
        assert_valid(self.dfg, new_plan, cost=self.cost,
                     pipeline_depth=self.pipeline_depth, context="replan")
        self.plan = new_plan
        self._rebuild_mesh_devs()

    def add_hosts(self, k: int = 1):
        """Declare ``k`` new hosts joining the cluster.  Consumed at the
        next iteration retirement (the only point where no iteration
        boundary is straddled): the mesh grows via ``DeviceHealth`` and the
        ``replanner`` produces the expanded plan."""
        if k < 1:
            raise ValueError("add_hosts needs k >= 1")
        self._pending_gain += k

    def _apply_gain(self):
        k, self._pending_gain = self._pending_gain, 0
        if self.health is None:
            self.health = fault.DeviceHealth(self.plan.cluster)
        event = self.health.gain_hosts(k)
        grown, _node_map = self.health.compact()
        new_plan = self.replanner(grown, event)
        self.replan(new_plan)
        self.topology_events.append(event)

    def _recover(self, err: fault.DeviceLostError, resumed_iteration: int):
        """React to a host loss: mask the dead devices, replan on the
        surviving topology, and recover weights — live reshard through
        ``parallel/realloc_exec`` when any data-parallel replica of a model
        survives intact, checkpoint restore (``restore_models``) as the
        fallback.  Runs between event loops; the previous loop's executor
        threads were joined at shutdown, so no call is in flight.

        (This is a simulated fleet: a dead host's buffers still physically
        exist in host RAM, so "lost" is the *logical* determination the
        replica analysis makes — exactly the one a real deployment faces.)
        """
        t_start = time.monotonic()
        if not err.nodes:
            raise err  # nothing to mask — unattributable loss is fatal
        if self.health is None:
            self.health = fault.DeviceHealth(self.plan.cluster)
        for n in err.nodes:
            if n not in self.health.dead_nodes:
                self.health.mark_host_dead(n)
            # an in-progress migration for a node that actually died is
            # moot — the reactive path takes over from here
            self._migrations.pop(n, None)
        event = fault.TopologyEvent("loss", tuple(err.nodes),
                                    at=time.monotonic())
        dead = self.health.dead_devices()
        m = self.plan.cluster.devs_per_node
        lost = []
        for name, st in self.models.items():
            if not _leaves(st.params):
                continue  # paramless model: nothing to recover
            self._drain_prefetch_sync(name)  # belt-and-braces; see finally
            asg = st.assignment
            params_lost = (asg is not None and (asg.mesh.devices(m) & dead)
                           and not fault.has_live_replica(asg, dead, m))
            # opt states are first-class sharded trees: a TRAIN step with
            # live params but lost moments would silently corrupt training
            oasg = st.opt_assignment
            opt_lost = (oasg is not None
                        and bool(_leaves(st.opt_state))
                        and (oasg.mesh.devices(m) & dead)
                        and not fault.has_live_replica(oasg, dead, m))
            if params_lost or opt_lost:
                lost.append(name)
        surviving, node_map = self.health.compact()
        t0 = time.monotonic()
        new_plan = self.replanner(surviving, event)
        replan_s = time.monotonic() - t0
        self.replan(new_plan)
        # surviving migrations (other noticed hosts) renumber with the mesh
        self._migrations = {node_map[n]: mig
                            for n, mig in self._migrations.items()
                            if n in node_map}
        for st in self.models.values():
            # old assignments are in dead coordinates; every model
            # reshards onto the new plan before its next call
            st.assignment = None
            st.opt_assignment = None
        restore_s = 0.0
        if lost:
            if self.restore_models is None:
                raise err
            t0 = time.monotonic()
            self.restore_models(sorted(lost))
            restore_s = time.monotonic() - t0
        reshard_s, moved = self._reshard_all_sync()
        rec = {
            "mode": "checkpoint" if lost else "live",
            "dead_nodes": sorted(err.nodes),
            "lost_models": sorted(lost),
            "resumed_iteration": resumed_iteration,
            "surviving_devices": surviving.size,
            "replan_s": replan_s,
            "restore_s": restore_s,
            "reshard_s": reshard_s,
            "moved_bytes": moved,
            "total_s": time.monotonic() - t_start,
        }
        self.recoveries.append(rec)
        self.topology_events.append(event)
        return rec

    def _reshard_all_sync(self) -> tuple[float, int]:
        """Reshard every model's live weights onto its first planned
        assignment, synchronously (recovery runs between event loops).
        Restored-from-checkpoint weights take the same path: the restore
        lands them host-side and this places them on the survivor mesh."""
        if self.sharding_for is None:
            return 0.0, 0
        t0 = time.monotonic()
        moved = 0
        for model_name, calls in self._model_call_chains().items():
            st = self.models.get(model_name)
            if st is None or not calls or not _leaves(st.params):
                continue
            target = self._assignment_for(calls[0].name)
            dst = self.sharding_for(model_name, target)
            if dst is not None:
                task = _reshard(st.params, dst)
                st.params = task.tree
                task.wait()
                moved += task.moved_bytes
                st.assignment = target
            # recover the opt state live too: it lands on the model's
            # TRAIN assignment, the layout its next train step expects
            if (self.opt_sharding_for is not None
                    and _leaves(st.opt_state)):
                train = [c for c in calls if c.call_type == TRAIN]
                opt_target = (self._assignment_for(train[0].name)
                              if train else target)
                odst = self.opt_sharding_for(model_name, opt_target)
                if odst is not None:
                    task = _reshard(st.opt_state, odst)
                    st.opt_state = task.tree
                    task.wait()
                    moved += task.moved_bytes
                    self.opt_state_resharded_bytes += task.moved_bytes
                    st.opt_assignment = opt_target
        return time.monotonic() - t0, moved

    def stats(self) -> dict:
        if not self.records:
            return {}
        t0 = min(r.start for r in self.records)
        calls: dict[str, dict] = {}
        for r in self.records:
            # aggregate by base name: unrolled ``name@t`` records of one call
            # fold into a single row
            agg = calls.setdefault(base_name(r.name),
                                   {"count": 0, "total_s": 0.0})
            agg["count"] += 1
            agg["total_s"] += r.end - r.start
        for agg in calls.values():
            agg["total_s"] = round(agg["total_s"], 4)
            agg["mean_s"] = round(agg["total_s"] / agg["count"], 4)
        return {
            "wall_s": max(r.end for r in self.records) - t0,
            "realloc_s": sum(r.realloc_s for r in self.records),
            "realloc_bytes": sum(r.realloc_bytes for r in self.records),
            "stragglers": sum(r.straggled for r in self.records),
            "retries": sum(r.retried for r in self.records),
            "prefetch_hits": sum(r.prefetch_hit for r in self.records),
            "cross_iter_prefetch_hits": sum(r.prefetch_cross
                                            for r in self.records),
            "iterations": getattr(self, "iterations_done", 0),
            # getattr: stats() also serves partially-constructed engines
            "recalibrations": getattr(self, "recalibrations", 0),
            "replans": getattr(self, "replans", 0),
            "recoveries": len(getattr(self, "recoveries", [])),
            "preemption_migrations": sum(
                1 for r in getattr(self, "recoveries", [])
                if r.get("mode") == "migrate"),
            "speculative_dispatches": sum(r.speculated
                                          for r in self.records),
            "speculative_wins": sum(r.spec_won for r in self.records),
            "opt_state_resharded_bytes": getattr(
                self, "opt_state_resharded_bytes", 0),
            "aborted_calls": getattr(self, "aborted_calls", 0),
            "prefetch_aborted": getattr(self, "prefetch_aborted", 0),
            "calls": calls,
        }
