"""Parameter reallocation schedule — the paper's Fig. 6 hierarchical remap.

Outer loop: every pair of (src pipeline stage i, dst pipeline stage j)
communicates the parameters of their common layers.  Inner loop: each layer's
TP partitions are remapped from the (dp1, tp1) grid of stage i to the
(dp2, tp2) grid of stage j; every destination GPU is assigned the source GPU
with the lowest communication cost (same device < same node < remote), and
assigned sources broadcast in parallel.

The schedule is hardware-agnostic; ``parallel/realloc_exec.py`` realizes the
equivalent resharding with XLA collectives, and the estimator/simulator use
this module's byte/time accounting.

The port's copy of the JAX package's ``core/realloc.py`` (framework-free): it
computes the same numbers, and only its import paths differ.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

from repro_torch.configs.base import ModelConfig
from repro_torch.core.dfg import FunctionCall
from repro_torch.core.plan import Assignment, Cluster

BF16 = 2


# --------------------------------------------------------------- layouts

def layer_bytes(cfg: ModelConfig) -> list[float]:
    """Per-'layer' parameter bytes; embedding and head are extra pseudo-layers
    (index 0 and -1) so PP stage remapping moves them too."""
    embed = cfg.vocab_size * cfg.d_model * BF16
    body = [cfg.layer_params(s) * BF16 for s in cfg.layers]
    head = embed if not cfg.tie_embeddings else 0.0
    return [float(embed)] + [float(b) for b in body] + [float(head)]


def stage_ranges(n_layers: int, pp: int) -> list[tuple[int, int]]:
    """Contiguous, balanced layer ranges per pipeline stage."""
    base, rem = divmod(n_layers, pp)
    out, start = [], 0
    for s in range(pp):
        size = base + (1 if s < rem else 0)
        out.append((start, start + size))
        start += size
    return out


def grid_devices(asg: Assignment, cluster: Cluster) -> list[list[list[int]]]:
    """Device ids arranged as [pp][dp][tp] (row-major over the mesh)."""
    devs = sorted(asg.mesh.devices(cluster.devs_per_node))
    s = asg.strategy
    out, it = [], iter(devs)
    for _ in range(s.pp):
        stage = []
        for _ in range(s.dp):
            stage.append([next(it) for _ in range(s.tp)])
        out.append(stage)
    return out


# --------------------------------------------------------------- schedule

@dataclasses.dataclass(frozen=True)
class CommOp:
    layer: int
    frac_start: Fraction  # TP-slice interval of the layer being moved
    frac_end: Fraction
    src: int
    dsts: tuple[int, ...]
    bytes: float


@dataclasses.dataclass
class Schedule:
    ops: list[CommOp]
    total_bytes: float
    time: float
    # total_bytes counts only bytes actually put on the wire — the
    # planning-level counterpart of realloc_exec.ReshardTask.moved_bytes
    local_hits: int  # dst already held the piece (no transfer)

    def moved_layers(self) -> set[int]:
        """Indices of the (pseudo-)layers with at least one transfer op —
        the per-leaf move plan: layers absent here keep their layout and
        their parameter leaves alias through the partial reshard."""
        return {op.layer for op in self.ops}


def _cost_class(src: int, dst: int, cluster: Cluster) -> int:
    if src == dst:
        return 0
    if cluster.node_of(src) == cluster.node_of(dst):
        return 1
    return 2


@dataclasses.dataclass
class _Memo:
    cache: dict = dataclasses.field(default_factory=dict)


_MEMO = _Memo()
_MEMO_CAP = 8192


def remap_schedule(cfg: ModelConfig, src: Assignment, dst: Assignment,
                   cluster: Cluster) -> Schedule:
    """Memoized: MCMC re-evaluates the same (src, dst) pairs constantly and
    the inner loops scale with layers x devices.  Beyond 64-device meshes the
    exact Fig. 6 schedule is replaced by its closed-form cost (every source
    broadcasts its shard once, in parallel), keeping >1000-GPU searches fast;
    the exact algorithm remains the tested reference at realistic mesh sizes."""
    key = (cfg.name, src, dst, cluster.n_nodes, cluster.devs_per_node)
    hit = _MEMO.cache.get(key)
    if hit is not None:
        return hit
    if max(src.mesh.size, dst.mesh.size) > 64:
        out = _remap_cost_fast(cfg, src, dst, cluster)
    else:
        out = _remap_schedule(cfg, src, dst, cluster)
    if len(_MEMO.cache) > _MEMO_CAP:
        # evict the oldest half (dict preserves insertion order) so the MCMC
        # search keeps its hot working set instead of losing it to a clear()
        for old in list(_MEMO.cache)[:len(_MEMO.cache) // 2]:
            del _MEMO.cache[old]
    _MEMO.cache[key] = out
    return out


def _remap_cost_fast(cfg: ModelConfig, src: Assignment, dst: Assignment,
                     cluster: Cluster) -> Schedule:
    """Closed-form cost of the hierarchical broadcast: unique pieces =
    model_bytes spread over the pp1*tp1 source shards, broadcast in parallel
    (fan-out to dp2 replicas pipelines); remote when node ranges differ."""
    total = sum(layer_bytes(cfg))
    s1, s2 = src.strategy, dst.strategy
    per_src = total / (s1.pp * s1.tp)
    same_nodes = (src.mesh.node_start == dst.mesh.node_start
                  and src.mesh.node_count == dst.mesh.node_count)
    if src == dst:
        return Schedule([], 0.0, 0.0, 0)
    bw = cluster.intra_node_bw if (same_nodes and src.mesh.node_count == 1) \
        else cluster.inter_node_bw
    pieces = max(s1.tp, s2.tp) * max(s1.pp, s2.pp)
    time = per_src / bw + 2e-6 * pieces / max(s1.pp * s1.tp, 1)
    dst_copies = s2.dp * s2.tp * s2.pp
    return Schedule([], total * min(dst_copies, s2.dp), time, 0)


def _remap_schedule(cfg: ModelConfig, src: Assignment, dst: Assignment,
                    cluster: Cluster) -> Schedule:
    lb = layer_bytes(cfg)
    n_layers = len(lb)
    s1, s2 = src.strategy, dst.strategy
    src_stages = stage_ranges(n_layers, s1.pp)
    dst_stages = stage_ranges(n_layers, s2.pp)
    src_grid = grid_devices(src, cluster)
    dst_grid = grid_devices(dst, cluster)

    # (src_dev, layer, frac interval) -> set of dst devices
    groups: dict[tuple, set[int]] = {}
    local_hits = 0

    for j, (d0, d1) in enumerate(dst_stages):           # outer loop: dst stage
        for i, (s0, s1e) in enumerate(src_stages):      # x src stage
            lo, hi = max(d0, s0), min(d1, s1e)
            if lo >= hi:
                continue
            for layer in range(lo, hi):                  # common layers
                if lb[layer] == 0.0:
                    continue
                for dp2 in range(s2.dp):                 # inner loop: dst grid
                    for tp2 in range(s2.tp):
                        dst_dev = dst_grid[j][dp2][tp2]
                        want = (Fraction(tp2, s2.tp), Fraction(tp2 + 1, s2.tp))
                        # overlapping source TP slices
                        for tp1 in range(s1.tp):
                            have = (Fraction(tp1, s1.tp),
                                    Fraction(tp1 + 1, s1.tp))
                            a, b = max(want[0], have[0]), min(want[1], have[1])
                            if a >= b:
                                continue
                            # choose cheapest source replica over dp1
                            cands = [src_grid[i][dp1][tp1]
                                     for dp1 in range(s1.dp)]
                            sdev = min(cands, key=lambda c: _cost_class(
                                c, dst_dev, cluster))
                            if sdev == dst_dev:
                                local_hits += 1
                                continue
                            key = (sdev, layer, a, b)
                            groups.setdefault(key, set()).add(dst_dev)

    ops: list[CommOp] = []
    send_time: dict[int, float] = {}
    total_bytes = 0.0
    for (sdev, layer, a, b), dsts in sorted(groups.items(),
                                            key=lambda kv: (kv[0][0], kv[0][1])):
        nbytes = lb[layer] * float(b - a)
        remote = any(_cost_class(sdev, d, cluster) == 2 for d in dsts)
        bw = cluster.inter_node_bw if remote else cluster.intra_node_bw
        # pipelined broadcast: time ~ payload / bw irrespective of fan-out
        send_time[sdev] = send_time.get(sdev, 0.0) + nbytes / bw + 2e-6
        total_bytes += nbytes * len(dsts)
        ops.append(CommOp(layer, a, b, sdev, tuple(sorted(dsts)), nbytes))

    time = max(send_time.values(), default=0.0)
    return Schedule(ops, total_bytes, time, local_hits)


def coverage_ok(cfg: ModelConfig, src: Assignment, dst: Assignment,
                cluster: Cluster, sched: Schedule) -> bool:
    """Every dst device must end up with every byte of its TP slice of every
    layer in its stage (either transferred or already local)."""
    lb = layer_bytes(cfg)
    s1, s2 = src.strategy, dst.strategy
    src_stages = stage_ranges(len(lb), s1.pp)
    dst_stages = stage_ranges(len(lb), s2.pp)
    src_grid = grid_devices(src, cluster)
    dst_grid = grid_devices(dst, cluster)

    received: dict[tuple[int, int], list[tuple[Fraction, Fraction]]] = {}
    for op in sched.ops:
        for d in op.dsts:
            received.setdefault((d, op.layer), []).append(
                (op.frac_start, op.frac_end))

    def holds_locally(dev, layer, a, b):
        for i, (s0, s1e) in enumerate(src_stages):
            if not (s0 <= layer < s1e):
                continue
            for dp1 in range(s1.dp):
                for tp1 in range(s1.tp):
                    if src_grid[i][dp1][tp1] != dev:
                        continue
                    ha, hb = Fraction(tp1, s1.tp), Fraction(tp1 + 1, s1.tp)
                    if ha <= a and b <= hb:
                        return True
        return False

    for j, (d0, d1) in enumerate(dst_stages):
        for layer in range(d0, d1):
            if lb[layer] == 0.0:
                continue
            for dp2 in range(s2.dp):
                for tp2 in range(s2.tp):
                    dev = dst_grid[j][dp2][tp2]
                    want = [(Fraction(tp2, s2.tp), Fraction(tp2 + 1, s2.tp))]
                    pieces = received.get((dev, layer), [])
                    # subtract received + locally-held pieces
                    for a, b in want:
                        cur = a
                        segs = sorted([p for p in pieces if p[0] < b and p[1] > a])
                        for pa, pb in segs:
                            if pa > cur:
                                if not holds_locally(dev, layer, cur, pa):
                                    return False
                            cur = max(cur, pb)
                        if cur < b and not holds_locally(dev, layer, cur, b):
                            return False
    return True


# --------------------------------------------------------- data transfer

def data_bytes(producer: FunctionCall, consumer: FunctionCall) -> float:
    """Bytes of intermediate data on a dfg edge (tokens / logprobs / rewards);
    tiny compared to parameters (paper Fig. 11)."""
    w = producer.workload
    per_tok = 0.0
    for out in producer.outputs:
        if out in ("seq", "pairs", "seq_greedy"):
            per_tok += 4.0
        elif out in ("logp", "ref_logp", "values"):
            per_tok += 4.0
        elif out in ("rewards", "rewards_baseline"):
            per_tok += 4.0 / max(w.seq_len, 1)
    return w.batch * w.seq_len * per_tok


def data_transfer_time(nbytes: float, src: Assignment, dst: Assignment,
                       cluster: Cluster) -> float:
    """Broadcast-based transfer (same algorithm as params, TP/DP reversed):
    each dst DP shard receives its slice from the cheapest producer replica."""
    if nbytes <= 0:
        return 0.0
    same_node = (src.mesh.node_count == 1 and dst.mesh.node_count == 1
                 and src.mesh.node_start == dst.mesh.node_start)
    bw = cluster.intra_node_bw if same_node else cluster.inter_node_bw
    # payload splits across src DP ranks; fan-out to dst replicas pipelines
    return nbytes / max(src.strategy.dp, 1) / bw + 5e-6
