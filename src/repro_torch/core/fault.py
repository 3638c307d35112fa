"""Fault model for the elastic runtime: deterministic chaos injection, a
device-health view of the cluster, and the retry policy.

ReaL's premise — parameters can be redistributed across the cluster at will
(paper §4-5) — is exactly the machinery needed to *survive* device loss and
exploit device gain without a restart: on a topology change the runtime
replans on the surviving cluster and reshards live weights onto the new
plan.  This module holds the pieces that do not touch the event loop:

* :class:`FaultInjector` — a scripted (deterministic, replayable) source of
  faults: kill a simulated host mid-iteration, delay a call, fail a call
  transiently N times, or deliver a *preemption notice* (the host will die
  in ``deadline_s`` — a spot/maintenance eviction).  Injection happens
  inside the executor thread of the matched call, exactly where a real
  device fault would surface; notices never raise — they are queued and the
  runtime polls :meth:`FaultInjector.take_notices`.
* :class:`DeviceHealth` — which hosts of the *current logical cluster* are
  dead, doomed (noticed, still serving), retired (migrated off before their
  deadline), plus pending host gains; ``compact()`` renumbers the survivors
  into a dense :class:`~repro.core.plan.Cluster` so successive failures
  compose.  Retiring a host deliberately does NOT renumber: migration
  happens under a live window whose in-flight calls hold device locks in
  the current coordinates.
* :class:`RetryPolicy` — configurable retry for transient call failures
  (max attempts, exponential backoff, per-call-type overrides, straggler
  deadline factor), replacing the engine's historical hardcoded single
  retry.
* :func:`has_live_replica` — the recovery triage: a model's weights are
  recoverable live iff at least one data-parallel replica group of its
  current assignment contains no dead device.

The hardware layer (``hw.py``) describes devices; this module describes
their *availability*.  Events carry logical node ids in the coordinates of
the cluster at the time of the event.

The port's copy of the JAX package's ``core/fault.py`` (framework-free): it
computes the same numbers, and only its import paths differ.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional

from repro_torch.core.dfg import base_name
from repro_torch.core.plan import Assignment, Cluster

__all__ = [
    "TransientError", "DeviceLostError", "TopologyEvent", "PreemptionNotice",
    "DeviceHealth", "RetryPolicy", "FaultInjector", "replica_groups",
    "has_live_replica",
]


class TransientError(RuntimeError):
    """A call failure that is expected to succeed on retry (injected or
    surfaced by a flaky collective)."""


class DeviceLostError(RuntimeError):
    """A host (and all its devices) dropped out of the cluster.

    ``nodes`` are logical node indices in the coordinates of the plan's
    cluster at the time the fault surfaced.  The runtime treats this as a
    topology change, not a retryable call failure: it aborts the in-flight
    window, masks the nodes out, replans on the survivors, and recovers
    weights live (or from checkpoint when every replica died).
    """

    def __init__(self, nodes=(), message: str = "host lost"):
        super().__init__(message)
        self.nodes = tuple(nodes)


@dataclasses.dataclass(frozen=True)
class TopologyEvent:
    """One topology change, in the cluster coordinates current at the time.

    ``kind`` is "loss", "gain", "notice" (a preemption notice: the nodes
    will die soon but still serve — replans triggered by it must *avoid*
    them without renumbering the cluster) or "retire" (a noticed host was
    fully migrated off before its deadline); ``nodes`` the affected logical
    node ids (for gains: the ids the new hosts will occupy after
    ``compact()``)."""

    kind: str
    nodes: tuple[int, ...]
    at: float = 0.0

    def __post_init__(self):
        if self.kind not in ("loss", "gain", "notice", "retire"):
            raise ValueError(f"unknown topology event kind {self.kind!r}")


@dataclasses.dataclass(frozen=True)
class PreemptionNotice:
    """A scripted advance warning: ``node`` will be lost ``deadline_s``
    seconds after ``at`` (monotonic).  Delivered by the injector's queue
    (never raised) — real fleets surface these via a metadata endpoint or
    SIGTERM long before the host actually dies."""

    node: int
    deadline_s: float
    at: float = 0.0


class DeviceHealth:
    """Availability of the logical cluster's hosts.

    Tracks dead nodes (and pending gained nodes) in the coordinates of
    ``self.cluster``.  ``compact()`` produces the dense surviving cluster
    plus the old-node -> new-node renumbering, then resets to an
    all-healthy view of it — so a second failure after a recovery is
    expressed in the *new* coordinates, and the two compose.
    """

    def __init__(self, cluster: Cluster):
        self.cluster = cluster
        self.dead_nodes: set[int] = set()
        self.doomed_nodes: set[int] = set()  # noticed, still serving
        self.retired_nodes: set[int] = set()  # migrated off, ids kept stable
        self.pending_gain: int = 0
        self.events: list[TopologyEvent] = []

    # ------------------------------------------------------------- mutation
    def mark_host_dead(self, node: int) -> TopologyEvent:
        if not (0 <= node < self.cluster.n_nodes):
            raise ValueError(
                f"node {node} outside cluster of {self.cluster.n_nodes}")
        self.dead_nodes.add(node)
        self.doomed_nodes.discard(node)  # the notice, if any, came true
        self.retired_nodes.discard(node)
        ev = TopologyEvent("loss", (node,), at=time.monotonic())
        self.events.append(ev)
        return ev

    def notice(self, node: int, deadline_s: float) -> TopologyEvent:
        """Record a preemption notice: ``node`` keeps serving but is doomed.
        Replans triggered by the returned event must avoid it."""
        if not (0 <= node < self.cluster.n_nodes):
            raise ValueError(
                f"node {node} outside cluster of {self.cluster.n_nodes}")
        if node in self.dead_nodes:
            raise ValueError(f"node {node} is already dead")
        self.doomed_nodes.add(node)
        ev = TopologyEvent("notice", (node,), at=time.monotonic())
        self.events.append(ev)
        return ev

    def retire_host(self, node: int) -> TopologyEvent:
        """A doomed host finished migrating: drop it from service *without*
        renumbering the survivors (in-flight state holds current
        coordinates).  ``compact()`` folds retired hosts out like dead
        ones."""
        if node not in self.doomed_nodes:
            raise ValueError(f"node {node} was never noticed as doomed")
        self.doomed_nodes.discard(node)
        self.retired_nodes.add(node)
        ev = TopologyEvent("retire", (node,), at=time.monotonic())
        self.events.append(ev)
        return ev

    def gain_hosts(self, k: int) -> TopologyEvent:
        if k < 1:
            raise ValueError("gain_hosts needs k >= 1")
        alive = self.cluster.n_nodes - len(self.dead_nodes)
        new = tuple(range(alive, alive + k))
        self.pending_gain += k
        ev = TopologyEvent("gain", new, at=time.monotonic())
        self.events.append(ev)
        return ev

    # -------------------------------------------------------------- queries
    def dead_devices(self) -> frozenset[int]:
        """Flat device ids of every dead host (current coordinates)."""
        m = self.cluster.devs_per_node
        return frozenset(d for n in self.dead_nodes
                         for d in range(n * m, (n + 1) * m))

    def doomed_devices(self) -> frozenset[int]:
        """Flat device ids of every doomed (noticed, still serving) host."""
        m = self.cluster.devs_per_node
        return frozenset(d for n in self.doomed_nodes
                         for d in range(n * m, (n + 1) * m))

    @property
    def healthy(self) -> bool:
        return (not self.dead_nodes and not self.doomed_nodes
                and not self.retired_nodes and self.pending_gain == 0)

    # ------------------------------------------------------------ compaction
    def compact(self) -> tuple[Cluster, dict[int, int]]:
        """Fold deaths, retirements and gains into a dense cluster.

        Returns ``(new_cluster, node_map)`` where ``node_map`` renumbers
        surviving old nodes to their new ids (dead and retired nodes are
        absent; gained nodes take the ids after the survivors).  Resets
        this health view to all-healthy on the new cluster.  Doomed (not
        yet retired) nodes are kept — they are still serving.
        """
        gone = self.dead_nodes | self.retired_nodes
        survivors = [n for n in range(self.cluster.n_nodes)
                     if n not in gone]
        n_new = len(survivors) + self.pending_gain
        if n_new < 1:
            raise RuntimeError("no hosts survive the topology change")
        node_map = {old: i for i, old in enumerate(survivors)}
        new = dataclasses.replace(self.cluster, n_nodes=n_new)
        self.cluster = new
        self.dead_nodes = set()
        self.doomed_nodes = {node_map[n] for n in self.doomed_nodes
                             if n in node_map}
        self.retired_nodes = set()
        self.pending_gain = 0
        return new, node_map


# ---------------------------------------------------------------- replicas
def replica_groups(asg: Assignment, devs_per_node: int) -> list[frozenset]:
    """Data-parallel replica groups of an assignment.

    The mesh's flat device list (sorted) is split into ``dp`` contiguous
    chunks of ``tp * pp`` devices — the device set holding one complete
    copy of the model under the assignment's strategy.
    """
    devs = sorted(asg.mesh.devices(devs_per_node))
    per = asg.strategy.tp * asg.strategy.pp
    return [frozenset(devs[i * per:(i + 1) * per])
            for i in range(asg.strategy.dp)]


def has_live_replica(asg: Assignment, dead: frozenset,
                     devs_per_node: int) -> bool:
    """True iff at least one replica group survives ``dead`` intact — the
    condition under which weights can be recovered live (resharded from the
    surviving copy) instead of restored from checkpoint."""
    return any(not (g & dead) for g in replica_groups(asg, devs_per_node))


# ---------------------------------------------------------------- injection
@dataclasses.dataclass
class _Fault:
    kind: str                       # "transient" | "delay" | "kill" | "notice"
    call: Optional[str] = None      # base call name; None matches any call
    at_iteration: Optional[int] = None  # absolute iteration; None = any
    times: int = 1                  # remaining firings
    delay_s: float = 0.0            # for "notice": the preemption deadline
    nodes: tuple[int, ...] = ()
    message: str = "injected fault"


class FaultInjector:
    """Deterministic, scripted chaos: faults fire when a matching call
    executes, in program order, never at random — so every chaos test and
    benchmark run is exactly replayable.

    The runtime invokes :meth:`on_execute` inside the executor thread of
    each call, before the model function runs (where a real device fault
    would surface).  Matching faults fire in the order they were armed and
    decrement their remaining count; a "kill" raises
    :class:`DeviceLostError`, a "transient" raises :class:`TransientError`,
    and a "delay" sleeps in the executor thread (stalling the call past the
    straggler deadline without failing it).
    """

    def __init__(self):
        self._faults: list[_Fault] = []
        self._lock = threading.Lock()
        self.fired: list[tuple[str, str, int]] = []  # (kind, call, iter)
        self._notices: list[PreemptionNotice] = []  # queued, never raised

    # ---------------------------------------------------------------- arming
    def fail_transient(self, call: Optional[str] = None, *, times: int = 1,
                       at_iteration: Optional[int] = None,
                       message: str = "injected transient failure"):
        self._faults.append(_Fault("transient", call, at_iteration, times,
                                   message=message))
        return self

    def delay_call(self, call: Optional[str] = None, *, seconds: float,
                   times: int = 1, at_iteration: Optional[int] = None):
        self._faults.append(_Fault("delay", call, at_iteration, times,
                                   delay_s=seconds))
        return self

    def kill_host(self, node: int, *, at_call: Optional[str] = None,
                  at_iteration: Optional[int] = None):
        """Arm a host kill: the next matching call dies with
        :class:`DeviceLostError` naming ``node``."""
        self._faults.append(_Fault(
            "kill", at_call, at_iteration, times=1, nodes=(node,),
            message=f"injected loss of host {node}"))
        return self

    def notice(self, node: int, deadline_s: float, *,
               at_call: Optional[str] = None,
               at_iteration: Optional[int] = None):
        """Arm a preemption notice: when the next matching call executes, a
        :class:`PreemptionNotice` for ``node`` (dying in ``deadline_s``) is
        *queued* — never raised; the call proceeds normally — for the
        runtime to pick up via :meth:`take_notices`."""
        self._faults.append(_Fault(
            "notice", at_call, at_iteration, times=1, delay_s=deadline_s,
            nodes=(node,),
            message=f"preemption notice for host {node}"))
        return self

    def take_notices(self) -> list[PreemptionNotice]:
        """Drain the queued preemption notices (oldest first)."""
        with self._lock:
            out, self._notices = self._notices, []
        return out

    # --------------------------------------------------------------- firing
    def on_execute(self, call_name: str, iteration: int) -> None:
        """Called by the runtime in the executor thread of ``call_name`` at
        absolute ``iteration``, before the model function runs."""
        base = base_name(call_name)
        with self._lock:
            fault = None
            for f in self._faults:
                if f.times <= 0:
                    continue
                if f.call is not None and f.call != base:
                    continue
                if (f.at_iteration is not None
                        and f.at_iteration != iteration):
                    continue
                f.times -= 1
                fault = f
                break
            if fault is None:
                return
            self.fired.append((fault.kind, base, iteration))
            if fault.kind == "notice":
                self._notices.extend(
                    PreemptionNotice(n, fault.delay_s, time.monotonic())
                    for n in fault.nodes)
                return
        if fault.kind == "delay":
            time.sleep(fault.delay_s)
            return
        if fault.kind == "transient":
            raise TransientError(fault.message)
        raise DeviceLostError(nodes=fault.nodes, message=fault.message)


# ------------------------------------------------------------------- retry
@dataclasses.dataclass
class RetryPolicy:
    """Retry behaviour for failed calls (transient errors only —
    :class:`DeviceLostError` always escalates to topology recovery).

    ``max_attempts`` counts the first try: the default (2, no backoff)
    reproduces the engine's historical single-retry-after-re-realloc.
    ``backoff_s`` is the first retry's sleep, growing by
    ``backoff_factor`` per subsequent attempt, capped at
    ``max_backoff_s``.  ``straggler_factor``, when set, overrides the
    engine-level deadline multiplier feeding the ``on_straggler`` hook.
    ``overrides`` maps call types (e.g. ``dfg.GENERATE``) to full
    per-call-type policies.
    """

    max_attempts: int = 2
    backoff_s: float = 0.0
    backoff_factor: float = 2.0
    max_backoff_s: float = 5.0
    straggler_factor: Optional[float] = None
    overrides: dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")

    def for_call_type(self, call_type: str) -> "RetryPolicy":
        return self.overrides.get(call_type, self)

    def backoff_for(self, failures: int) -> float:
        """Sleep before the retry following the ``failures``-th failure."""
        if self.backoff_s <= 0:
            return 0.0
        return min(self.backoff_s * self.backoff_factor ** (failures - 1),
                   self.max_backoff_s)
