"""Profiling-assisted calibration (paper §5.1, Fig. 12-left).

The paper profiles per-layer forward/backward/communication times over a
power-of-two grid of input sizes (minutes per model family), persists the
profile, and feeds it to the estimator of every later experiment on the same
hardware.  This module reproduces that whole loop:

  * ``profile_model``    — measure real jitted train/inference steps over the
                           size grid into a ``ProfileTable``.
  * ``calibrate`` / ``fit_type_scales`` — fit the analytic model's scale
                           factors to the measured table.
  * ``ProfileStore``     — versioned on-disk JSON of tables + fitted scales,
                           keyed by (model name, hardware fingerprint from
                           ``repro.hw.fingerprint``), with merge and
                           staleness handling; reusable across experiments of
                           the same family exactly as in the paper.
  * ``fold_rollout_summary`` / ``fold_serve_summary`` — feed the measured
                           tokens/s from ``benchmarks/rollout_bench.py`` /
                           ``benchmarks/serve_bench.py`` JSON artifacts back
                           into the table as generation-time measurements.

The port's copy of the JAX package's ``core/profiler.py``.  The tables,
fits, store and folds are the same; two parts differ, each for torch:
``measure`` waits for the device (a synchronize before and after each
timed call) instead of ``block_until_ready``, and ``profile_model`` runs
the port's train step and LM loss on a ``device`` (the card by default).
The store keys on the port's ``hw.fingerprint()``.  The JSON schema is
documented in docs/CALIBRATION.md.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Optional

import torch

from repro_torch import hw
from repro_torch.configs.base import ModelConfig
from repro_torch.core.dfg import FunctionCall, GENERATE, Workload
from repro_torch.core.estimator import CostModel, Profile, assignment_key
from repro_torch.core.plan import Assignment, Cluster, DeviceMesh, ParallelStrategy

SCHEMA_VERSION = 1

#: assignment key of the single-device measurement context used by
#: ``profile_model`` (one host process, no parallelism).
SINGLE_DEV_KEY = assignment_key(
    Assignment(DeviceMesh(0, 1, 0, 1), ParallelStrategy(1, 1, 1, 1)))


@dataclasses.dataclass
class ProfileTable:
    """Raw measurements of one model family.

    ``entries`` maps ``(kind, batch, seq)`` to mean measured seconds, where
    ``kind`` is a call type ("train" | "inference" | "generate"), ``batch``
    the sequence count and ``seq`` the per-sequence token count.  ``counts``
    tracks samples per key so merges average correctly; ``by_asg`` keeps the
    same measurements keyed additionally by the assignment shape they were
    taken under (``estimator.assignment_key``) — the exact-hit override path
    of the calibrated ``CostModel``.
    """

    model_name: str
    entries: dict
    counts: dict = dataclasses.field(default_factory=dict)
    by_asg: dict = dataclasses.field(default_factory=dict)

    def add(self, kind: str, batch: int, seq: int, seconds: float,
            asg_key: Optional[str] = None, grid: bool = True) -> None:
        """Fold one measured call (wall seconds) into the running means.

        ``grid=False`` records only the exact-hit ``by_asg`` entry, keeping
        the interpolation grid (``entries``) clean — used for measurements
        of models other than this table's family.
        """
        key = (kind, int(batch), int(seq))
        if grid:
            n = self.counts.get(key, 1 if key in self.entries else 0)
            prev = self.entries.get(key, 0.0)
            self.entries[key] = (prev * n + seconds) / (n + 1)
            self.counts[key] = n + 1
        if asg_key is not None:
            akey = key + (asg_key,)
            mean, an = self.by_asg.get(akey, (0.0, 0))
            self.by_asg[akey] = ((mean * an + seconds) / (an + 1), an + 1)

    def lookup_exact(self, kind: str, batch: int, seq: int,
                     asg_key: Optional[str] = None) -> Optional[float]:
        """Mean measured seconds for an exactly-profiled point, else None.

        With ``asg_key`` the measurement must come from a congruent
        assignment shape; without it any measurement of the workload hits.
        """
        if asg_key is not None:
            got = self.by_asg.get((kind, batch, seq, asg_key))
            return got[0] if got is not None else None
        return self.entries.get((kind, batch, seq))

    def lookup(self, kind: str, batch: int, seq: int,
               asg_key: Optional[str] = None,
               min_points: int = 1) -> Optional[float]:
        """Paper's estimator behaviour, in seconds: exact hit, else linear
        interpolation between the nearest profiled token counts, else linear
        *extrapolation* continuing the slope of the nearest segment (the
        fixed per-call overhead survives below the grid; growth beyond the
        grid follows the last measured trend instead of a through-origin
        ray).

        With ``asg_key`` the interpolation runs over the ``by_asg``
        measurements of that assignment shape only — the mid tier of
        ``CostModel.call_time``, which must never blur measurements across
        parallelization strategies.  ``min_points`` is the minimum number of
        distinct profiled token counts required before answering (None
        otherwise); 2 disables the single-point proportional fallback.
        """
        exact = self.lookup_exact(kind, batch, seq, asg_key)
        if exact is not None:
            return exact
        tokens = batch * seq
        # distinct (batch, seq) points can share a token count (e.g. 8x96
        # and 24x32): collapse them to their mean so segment slopes are
        # well-defined
        by_tokens: dict[int, list[float]] = {}
        if asg_key is None:
            for (k, b, s), t in self.entries.items():
                if k == kind:
                    by_tokens.setdefault(b * s, []).append(t)
        else:
            for (k, b, s, a), (t, _n) in self.by_asg.items():
                if k == kind and a == asg_key:
                    by_tokens.setdefault(b * s, []).append(t)
        pts = sorted((x, sum(ts) / len(ts)) for x, ts in by_tokens.items())
        if not pts or len(pts) < min_points:
            return None
        if len(pts) == 1:  # no slope information: proportional fallback
            return pts[0][1] * tokens / pts[0][0]
        if tokens <= pts[0][0]:
            (x0, y0), (x1, y1) = pts[0], pts[1]
            slope = (y1 - y0) / (x1 - x0)
            return max(y0 - slope * (x0 - tokens), 1e-12)
        for (x0, y0), (x1, y1) in zip(pts, pts[1:]):
            if x0 <= tokens <= x1:
                f = (tokens - x0) / (x1 - x0)
                return y0 + f * (y1 - y0)
        (x0, y0), (x1, y1) = pts[-2], pts[-1]
        slope = (y1 - y0) / (x1 - x0)
        return max(y1 + slope * (tokens - x1), y1)

    def merge(self, other: "ProfileTable") -> None:
        """Fold another table's measurements into this one (count-weighted
        means), e.g. a fresh profiling run over a persisted one."""
        for key, t in other.entries.items():
            n_o = other.counts.get(key, 1)
            n_s = self.counts.get(key, 1 if key in self.entries else 0)
            prev = self.entries.get(key, 0.0)
            self.entries[key] = (prev * n_s + t * n_o) / (n_s + n_o)
            self.counts[key] = n_s + n_o
        for akey, (t, n_o) in other.by_asg.items():
            mean, n_s = self.by_asg.get(akey, (0.0, 0))
            self.by_asg[akey] = ((mean * n_s + t * n_o) / (n_s + n_o),
                                 n_s + n_o)

    # ------------------------------------------------------------ (de)serialize
    def to_json(self) -> dict:
        """JSON-safe dict (tuple keys flattened to rows; seconds values)."""
        return {
            "model_name": self.model_name,
            "entries": [[k, b, s, self.counts.get((k, b, s), 1), t]
                        for (k, b, s), t in sorted(self.entries.items())],
            "by_asg": [[k, b, s, a, n, t]
                       for (k, b, s, a), (t, n) in sorted(self.by_asg.items())],
        }

    @classmethod
    def from_json(cls, d: dict) -> "ProfileTable":
        t = cls(d["model_name"], {})
        for k, b, s, n, sec in d.get("entries", []):
            t.entries[(k, int(b), int(s))] = float(sec)
            t.counts[(k, int(b), int(s))] = int(n)
        for k, b, s, a, n, sec in d.get("by_asg", []):
            t.by_asg[(k, int(b), int(s), a)] = (float(sec), int(n))
        return t


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def measure(fn, *args, reps: int = 3) -> float:
    """Median wall time of one call in seconds, the device's work included.

    Two warm-up calls keep first-use effects (kernel builds, the caching
    allocator's first blocks) out of the samples; each rep is timed between
    two device synchronizes, so the sample spans the call's device work and
    not its asynchronous dispatch.  The median is robust to scheduler
    noise — one polluted sample must not poison an exact-hit profile
    entry.
    """
    for _ in range(2):
        fn(*args)
    _sync()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def profile_model(cfg: ModelConfig, *, batches=(2, 4), seqs=(32, 64),
                  seed: int = 0, device="cuda") -> ProfileTable:
    """Measure train/inference steps over the (powers-of-two) size grid.

    Returns a ``ProfileTable`` of mean wall seconds per call, with every
    point also recorded under the single-device assignment key so the
    calibrated ``CostModel`` takes exact hits for these workloads.  The
    train step is ``parallel.steps.make_train_step`` (LM loss, AdamW, no
    remat) and inference the LM loss under ``torch.no_grad()``, on
    ``device``: the CUDA kernels on the card, the reference tier on the
    host.
    """
    from repro_torch.models.model import init_params, lm_loss, synth_batch
    from repro_torch.optim import adamw
    from repro_torch.parallel.steps import make_train_step

    impl = "cuda" if torch.device(device).type == "cuda" else "reference"
    opt_cfg = adamw.AdamWConfig()
    p = init_params(cfg, seed=seed, device=device)
    for x in adamw.leaves(p):
        x.requires_grad_(True)
    opt = adamw.init(opt_cfg, p)
    train = make_train_step(cfg, opt_cfg, impl=impl, remat=False)

    @torch.no_grad()
    def infer(pp, b):
        return lm_loss(pp, cfg, b, impl=impl, remat=False)[0]

    table = ProfileTable(cfg.name, {})
    for b in batches:
        for s in seqs:
            batch = synth_batch(1, cfg, s, b, "train", device=device)
            table.add("train", b, s, measure(train, p, opt, batch),
                      asg_key=SINGLE_DEV_KEY)
            table.add("inference", b, s, measure(infer, p, batch),
                      asg_key=SINGLE_DEV_KEY)
    return table


def _ref_call(kind: str, cfg: ModelConfig, batch: int, seq: int) -> FunctionCall:
    """Reference call for fitting a table entry against the analytic model.
    Generate entries are measured over a whole prompt+decode run, so their
    analytic reference splits ``seq`` into a prompt half and a decoded half
    (folded bench summaries record them this way)."""
    if kind == GENERATE:
        w = Workload(batch, max(seq // 2, 1), seq - max(seq // 2, 1))
    else:
        w = Workload(batch, seq, 0)
    return FunctionCall("c", "m", kind, cfg, w)


def calibrate(cfg: ModelConfig, table: ProfileTable,
              cluster: Cluster) -> Profile:
    """Fit the analytic model's global scale (dimensionless) to the measured
    table via the median measured/analytic ratio — the 1-parameter analogue
    of the paper's per-layer fit."""
    asg = Assignment(DeviceMesh(0, 1, 0, 1), ParallelStrategy(1, 1, 1, 1))
    base = CostModel(cluster, Profile())
    ratios = []
    for (kind, b, s), t in table.entries.items():
        ratios.append(t / base.call_time(_ref_call(kind, cfg, b, s), asg))
    ratios.sort()
    scale = ratios[len(ratios) // 2]
    return Profile(compute_scale=scale, hbm_scale=scale, comm_scale=scale)


def fit_type_scales(cfg: ModelConfig, table: ProfileTable, cluster: Cluster,
                    profile: Optional[Profile] = None) -> dict[str, float]:
    """Per-call-type scale multipliers (dimensionless): for each call type in
    the table, the median ratio of measured seconds to the analytic estimate
    under ``profile``.  Finer-grained than ``calibrate``'s single global
    scale — train/inference/generate inefficiencies differ (paper Fig. 12).

    Fit against the SAME ``profile`` the consuming ``CostModel`` will use
    (the multipliers are residual corrections on top of it); fitting against
    the default profile and applying over a calibrated one double-scales.
    """
    asg = Assignment(DeviceMesh(0, 1, 0, 1), ParallelStrategy(1, 1, 1, 1))
    base = CostModel(cluster, profile)
    by_kind: dict[str, list[float]] = {}
    for (kind, b, s), t in table.entries.items():
        by_kind.setdefault(kind, []).append(
            t / base.call_cost(_ref_call(kind, cfg, b, s), asg).total)
    out = {}
    for kind, ratios in by_kind.items():
        ratios.sort()
        out[kind] = ratios[len(ratios) // 2]
    return out


# --------------------------------------------------------------- persistence

@dataclasses.dataclass
class ProfileEntry:
    """One persisted calibration: a model family's measurements + fitted
    scales on one hardware fingerprint.  ``created_at`` is a Unix timestamp
    in seconds (staleness handling)."""

    model_name: str
    fingerprint: str
    created_at: float
    table: ProfileTable
    profile: Profile
    type_scales: dict = dataclasses.field(default_factory=dict)
    realloc_scale: float = 1.0  # fitted ReshardTask measured/predicted ratio

    @property
    def key(self) -> str:
        return f"{self.model_name}|{self.fingerprint}"

    def cost_model(self, cluster: Cluster) -> CostModel:
        """A calibrated ``CostModel``: fitted global scales + per-call-type
        multipliers + the measurement table for exact-hit overrides."""
        return CostModel(cluster, profile=self.profile, table=self.table,
                         type_scales=dict(self.type_scales),
                         realloc_scale=self.realloc_scale)

    def age_s(self) -> float:
        """Entry age in seconds (for ``ProfileStore.get`` staleness)."""
        return max(0.0, time.time() - self.created_at)

    def to_json(self) -> dict:
        return {
            "model_name": self.model_name,
            "fingerprint": self.fingerprint,
            "created_at": self.created_at,
            "table": self.table.to_json(),
            "profile": dataclasses.asdict(self.profile),
            "type_scales": dict(self.type_scales),
            "realloc_scale": self.realloc_scale,
        }

    @classmethod
    def from_json(cls, d: dict) -> "ProfileEntry":
        return cls(d["model_name"], d["fingerprint"],
                   float(d.get("created_at", 0.0)),
                   ProfileTable.from_json(d["table"]),
                   Profile(**d.get("profile", {})),
                   dict(d.get("type_scales", {})),
                   float(d.get("realloc_scale", 1.0)))


class ProfileStore:
    """Versioned on-disk JSON store of ``ProfileEntry`` objects, keyed by
    ``"model_name|fingerprint"``.  Mirrors the paper's reuse of one profiling
    run across every experiment of the same model family + hardware.

    A file whose ``schema_version`` differs from ``SCHEMA_VERSION`` is
    treated as absent (profiles are cheap to re-measure; silent misreads are
    not).  ``get`` filters by fingerprint and optional ``max_age_s``.
    """

    def __init__(self, path: str):
        self.path = path
        self.entries: dict[str, ProfileEntry] = {}
        self.load()

    # --------------------------------------------------------------- disk IO
    def load(self) -> "ProfileStore":
        """(Re)read the backing file; missing/stale-schema files load empty."""
        self.entries = {}
        if not os.path.exists(self.path):
            return self
        try:
            with open(self.path) as f:
                d = json.load(f)
        except (OSError, json.JSONDecodeError):
            return self
        if d.get("schema_version") != SCHEMA_VERSION:
            return self
        for raw in d.get("entries", []):
            e = ProfileEntry.from_json(raw)
            self.entries[e.key] = e
        return self

    def save(self) -> None:
        """Atomically write all entries back to ``self.path``."""
        d = {"schema_version": SCHEMA_VERSION,
             "entries": [e.to_json() for e in self.entries.values()]}
        dirname = os.path.dirname(os.path.abspath(self.path))
        os.makedirs(dirname, exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(d, f, indent=1, sort_keys=True)
        os.replace(tmp, self.path)

    # ------------------------------------------------------------- accessors
    def get(self, model_name: str, fingerprint: Optional[str] = None,
            max_age_s: Optional[float] = None) -> Optional[ProfileEntry]:
        """Entry for (model, fingerprint), or None if absent or older than
        ``max_age_s`` seconds.  ``fingerprint`` defaults to this host's."""
        fingerprint = fingerprint or hw.fingerprint()
        e = self.entries.get(f"{model_name}|{fingerprint}")
        if e is None:
            return None
        if max_age_s is not None and e.age_s() > max_age_s:
            return None
        return e

    def put(self, entry: ProfileEntry, merge: bool = True) -> ProfileEntry:
        """Insert an entry; with ``merge`` (default) an existing entry's
        table is folded in (count-weighted) and the newer scales win."""
        old = self.entries.get(entry.key)
        if merge and old is not None:
            merged = ProfileTable(entry.table.model_name, {})
            merged.merge(old.table)
            merged.merge(entry.table)
            entry = dataclasses.replace(entry, table=merged)
        self.entries[entry.key] = entry
        return entry

    def put_cost_model(self, model_name: str, cost: CostModel,
                       fingerprint: Optional[str] = None) -> ProfileEntry:
        """Persist a (possibly runtime-refitted) calibrated ``CostModel``
        back into the store — the write half of the closed loop.  Replaces
        (no merge): a live cost model's table already evolved from the
        store's entry, so merging would double-count its measurements."""
        table = cost.table if cost.table is not None else \
            ProfileTable(model_name, {})
        entry = ProfileEntry(model_name, fingerprint or hw.fingerprint(),
                             time.time(), table, cost.prof,
                             dict(cost.type_scales),
                             getattr(cost, "realloc_scale", 1.0))
        return self.put(entry, merge=False)


def profile_and_store(cfg: ModelConfig, store: ProfileStore,
                      cluster: Cluster, *, batches=(2, 4), seqs=(32, 64),
                      max_age_s: Optional[float] = None,
                      fingerprint: Optional[str] = None,
                      device="cuda") -> ProfileEntry:
    """Load-or-profile: return the store's fresh entry for ``cfg`` on this
    hardware, measuring + fitting + persisting a new one when absent or
    older than ``max_age_s`` seconds."""
    fingerprint = fingerprint or hw.fingerprint()
    entry = store.get(cfg.name, fingerprint, max_age_s)
    if entry is not None:
        return entry
    table = profile_model(cfg, batches=batches, seqs=seqs, device=device)
    profile = calibrate(cfg, table, cluster)
    scales = fit_type_scales(cfg, table, cluster, profile)
    entry = store.put(ProfileEntry(cfg.name, fingerprint, time.time(),
                                   table, profile, scales))
    store.save()
    return entry


# ------------------------------------------------------- benchmark feedback

def fold_rollout_summary(table: ProfileTable, summary: dict) -> None:
    """Fold a ``benchmarks/rollout_bench.py --json`` summary into the table.

    The fused-path tokens/s becomes one measured "generate" call of the
    benchmark's (batch, prompt+gen) workload:
    seconds = batch * gen_len / tok_s.
    """
    tok_s = summary["tok_s"].get("fused") or max(summary["tok_s"].values())
    b, pl, gl = (summary["batch"], summary["prompt_len"], summary["gen_len"])
    table.add(GENERATE, b, pl + gl, b * gl / tok_s, asg_key=SINGLE_DEV_KEY)


def fold_serve_summary(table: ProfileTable, summary: dict) -> None:
    """Fold a ``benchmarks/serve_bench.py --json`` summary into the table.

    The continuous engine's whole run is treated as one coarse "generate"
    call: batch = request count, seq = mean prompt + mean generated tokens,
    seconds = measured wall time of the run.
    """
    w = summary["workload"]
    seq = int(round(w.get("mean_prompt", 0) + w["mean_new"]))
    table.add(GENERATE, w["requests"], max(seq, 1),
              summary["continuous"]["wall_s"], asg_key=SINGLE_DEV_KEY)
