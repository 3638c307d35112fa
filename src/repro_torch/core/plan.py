"""Execution plans: device meshes, parallelization strategies, plan objects.

Follows §4 of the paper.  A cluster is an (N nodes × M devices) grid; on the
TPU fleet a "node" is one row of the v5e 2D torus (M = 16 chips), so
intra-node ≈ one torus axis and inter-node ≈ the other (see DESIGN.md §2 for
the topology-assumption change vs. the paper's NVLink islands).

Legal device meshes (paper's search-space assumption #1):
  * k whole nodes (consecutive), any k >= 1; or
  * within one node: a power-of-two slice of size d | M, aligned to d.
This guarantees disjoint meshes can tile the cluster with no idle devices.

The port's copy of the JAX package's ``core/plan.py`` (framework-free): it
computes the same numbers, and only its import paths differ.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Iterable, Optional

from repro_torch import hw


@dataclasses.dataclass(frozen=True, order=True)
class DeviceMesh:
    """A rectangle of the cluster grid."""

    node_start: int
    node_count: int
    dev_start: int  # within-node offset (only != 0 for sub-node meshes)
    dev_count: int  # devices per node covered

    @property
    def size(self) -> int:
        return self.node_count * self.dev_count

    def devices(self, devs_per_node: int) -> frozenset[int]:
        return frozenset(
            n * devs_per_node + d
            for n in range(self.node_start, self.node_start + self.node_count)
            for d in range(self.dev_start, self.dev_start + self.dev_count))

    def fits(self, cluster: "Cluster") -> bool:
        """True when this rectangle lies inside ``cluster`` — the test that
        decides, after an elastic resize, whether an assignment can be kept
        verbatim (its parameters need not move at all)."""
        return (self.node_start + self.node_count <= cluster.n_nodes
                and self.dev_start + self.dev_count <= cluster.devs_per_node)

    def overlaps(self, other: "DeviceMesh") -> bool:
        if (self.node_start + self.node_count <= other.node_start or
                other.node_start + other.node_count <= self.node_start):
            return False
        if (self.dev_start + self.dev_count <= other.dev_start or
                other.dev_start + other.dev_count <= self.dev_start):
            return False
        return True

    def __str__(self):
        return (f"nodes[{self.node_start}:{self.node_start + self.node_count}]"
                f"x devs[{self.dev_start}:{self.dev_start + self.dev_count}]")


@dataclasses.dataclass(frozen=True)
class ParallelStrategy:
    """3D parallelism degrees + microbatch count (paper's S_i and mbs_i)."""

    dp: int = 1
    tp: int = 1
    pp: int = 1
    mbs: int = 1  # number of micro-batches fed sequentially

    @property
    def size(self) -> int:
        return self.dp * self.tp * self.pp

    def __str__(self):
        return f"d{self.dp}t{self.tp}p{self.pp}m{self.mbs}"


@dataclasses.dataclass(frozen=True)
class Cluster:
    n_nodes: int = 16
    devs_per_node: int = 16
    chip: hw.ChipSpec = dataclasses.field(default_factory=hw.ChipSpec)
    # bandwidth classes for the realloc/data-transfer cost model
    intra_node_bw: float = 50e9   # one torus hop
    inter_node_bw: float = 25e9   # cross-row path (shared links)

    @property
    def size(self) -> int:
        return self.n_nodes * self.devs_per_node

    def full_mesh(self) -> DeviceMesh:
        return DeviceMesh(0, self.n_nodes, 0, self.devs_per_node)

    def legal_meshes(self) -> list[DeviceMesh]:
        out = []
        m = self.devs_per_node
        # whole-node rectangles
        for count in range(1, self.n_nodes + 1):
            for start in range(0, self.n_nodes - count + 1):
                out.append(DeviceMesh(start, count, 0, m))
        # sub-node power-of-two slices
        d = 1
        while d < m:
            for node in range(self.n_nodes):
                for off in range(0, m, d):
                    out.append(DeviceMesh(node, 1, off, d))
            d *= 2
        return out

    def node_of(self, dev: int) -> int:
        return dev // self.devs_per_node


def strategies_for(mesh: DeviceMesh, cluster: Cluster, num_layers: int,
                   max_mbs: int = 32, tp_cap: Optional[int] = None,
                   decode_call: bool = False) -> list[ParallelStrategy]:
    """All (dp, tp, pp, mbs) with dp*tp*pp == mesh.size, pruned per §8.2:
    tp must fit in one node (torus row), pp cannot exceed layer count."""
    return list(_strategies_cached(
        mesh.size, mesh.dev_count, tp_cap or cluster.devs_per_node,
        num_layers, max_mbs))


@__import__("functools").lru_cache(maxsize=4096)
def _strategies_cached(n: int, dev_count: int, tp_cap: int, num_layers: int,
                       max_mbs: int) -> tuple:
    out = []
    for tp in _divisors(n):
        if tp > min(tp_cap, dev_count):
            continue
        for pp in _divisors(n // tp):
            if pp > num_layers:
                continue
            dp = n // tp // pp
            mbs_opts = {1, 2, 4, 8, 16, 32}
            for mbs in sorted(m for m in mbs_opts if m <= max_mbs):
                if mbs < pp and pp > 1:
                    continue  # pipeline needs >= pp microbatches to fill
                out.append(ParallelStrategy(dp, tp, pp, mbs))
    return tuple(out)


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


@dataclasses.dataclass(frozen=True)
class Assignment:
    mesh: DeviceMesh
    strategy: ParallelStrategy

    def __post_init__(self):
        assert self.mesh.size == self.strategy.size, (self.mesh, self.strategy)


@dataclasses.dataclass
class ExecutionPlan:
    """Assignment per model function call name (paper's p)."""

    assignments: dict[str, Assignment]
    cluster: Cluster

    def copy(self) -> "ExecutionPlan":
        return ExecutionPlan(dict(self.assignments), self.cluster)

    def fingerprint(self) -> tuple:
        return tuple(sorted(
            (k, a.mesh, a.strategy) for k, a in self.assignments.items()))

    def __str__(self):
        rows = [f"  {k:16s} {str(a.mesh):28s} {a.strategy}"
                for k, a in sorted(self.assignments.items())]
        return "ExecutionPlan(\n" + "\n".join(rows) + "\n)"


def symmetric_plan(call_names: Iterable[str], cluster: Cluster,
                   strategy: ParallelStrategy) -> ExecutionPlan:
    """Paper's 'symmetric' baseline: one global mesh + strategy for all calls."""
    mesh = cluster.full_mesh()
    return ExecutionPlan(
        {c: Assignment(mesh, strategy) for c in call_names}, cluster)
