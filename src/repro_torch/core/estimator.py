"""Lightweight runtime estimator (paper §5.1).

The paper profiles per-layer fwd/bwd/comm times on the real cluster and
interpolates.  Without hardware in this container, the estimator is an
*analytic roofline model* over the same structure — per-layer FLOPs / HBM
bytes / collective bytes derived from the ModelConfig, scaled by the hardware
constants in ``repro.hw`` — with two calibration hooks that play the role of
the paper's profiler when measurements exist:

  * ``Profile`` — global scale factors fitted by ``core.profiler.calibrate``.
  * measurement feedback — ``CostModel.record_measurement`` folds measured
    call times (from ``core.profiler.profile_model``, live
    ``RuntimeEngine`` CallRecords, or the benchmark JSON artifacts) into a
    ``ProfileTable``; ``refit`` recomputes per-call-type scale multipliers;
    exact measured hits for a (call type, workload, assignment) override the
    analytic estimate entirely (see docs/CALIBRATION.md).

Estimates, like the paper's, only need to (a) rank plans correctly and
(b) stay within ~25% of reality; ``benchmarks/estimator_acc.py`` validates
median relative error and rank preservation of the analytic vs calibrated
model against measured wall times.

The port's copy of the JAX package's ``core/estimator.py`` (framework-free): it
computes the same numbers, and only its import paths differ.
"""

from __future__ import annotations

import dataclasses

from repro_torch import hw
from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.core.dfg import GENERATE, INFERENCE, TRAIN, FunctionCall, Workload
from repro_torch.core.plan import Assignment, Cluster, ParallelStrategy

BF16 = 2
F32 = 4
ADAM_BYTES = 12  # fp32 m, v, master per param
GRAD_BYTES = 2   # bf16 grads (all-reduced in bf16)


@dataclasses.dataclass
class Profile:
    """Calibration multipliers (1.0 = pure analytic model).  A measured
    profile maps the analytic terms onto a specific machine, mirroring the
    paper's profiling step."""

    compute_scale: float = 1.0
    hbm_scale: float = 1.0
    comm_scale: float = 1.0
    coll_lat: float = 5e-6   # per-collective launch latency (s)
    p2p_lat: float = 2e-6    # per-hop p2p latency (s)
    eff_train: float = 0.50  # achievable MFU for large matmuls
    eff_prefill: float = 0.55
    eff_decode: float = 0.60  # decode compute efficiency (it is bw-bound anyway)


@dataclasses.dataclass(frozen=True)
class CallCost:
    """Analytic roofline terms of one call.  All fields are seconds."""

    compute: float
    hbm: float
    comm: float
    bubble: float

    @property
    def total(self) -> float:
        # compute and HBM traffic overlap poorly at these intensities; take
        # the max of the two rooflines, then add exposed comm + bubbles.
        return max(self.compute, self.hbm) + self.comm + self.bubble


def spec_expected_committed(accept_rate: float, k: int) -> float:
    """E[tokens committed per draft-and-verify cycle] = accepted prefix + 1
    resample/bonus token, under i.i.d. per-token accept rate ``a``:
    ``(1 - a^(k+1)) / (1 - a)`` (truncated geometric).  Shared convention
    with ``models.spec.SpecController.expected_committed``."""
    a = min(max(float(accept_rate), 0.0), 0.999999)
    return (1.0 - a ** (k + 1)) / (1.0 - a)


def assignment_key(asg: Assignment) -> str:
    """Serializable identity of an assignment for measurement keying.

    Cost is invariant to *where* a mesh sits (only its shape and the
    strategy matter), so the key is ``"n{nodes}x{devs}:{strategy}"`` —
    measurements taken under one assignment transfer to any congruent one.
    """
    m, s = asg.mesh, asg.strategy
    return f"n{m.node_count}x{m.dev_count}:{s}"


# --------------------------------------------------------------- workload math

def layer_flops_fwd(cfg: ModelConfig, seq_len: int, spec) -> float:
    """Forward FLOPs of one layer for ONE token sequence position, matmul
    2mnk convention, excluding the attention quadratic term."""
    p = cfg.layer_params(spec, active_only=True)
    return 2.0 * p


def attn_quad_flops_fwd(cfg: ModelConfig, tokens: int, seq_len: int) -> float:
    """Attention score+value FLOPs for a whole sequence batch (causal ~ /2)."""
    total = 0.0
    for spec in cfg.layers:
        if spec.kind != ATTN:
            continue
        kv_span = min(spec.window or seq_len, seq_len)
        total += 2.0 * 2.0 * tokens * kv_span * cfg.q_dim / 2.0
    if cfg.family == "encdec":
        total += 2.0 * 2.0 * tokens * cfg.prefix_len * cfg.q_dim  # cross-attn
    return total


def fwd_flops(cfg: ModelConfig, batch: int, seq_len: int) -> float:
    tokens = batch * seq_len
    return (2.0 * cfg.active_param_count() * tokens
            + attn_quad_flops_fwd(cfg, tokens, seq_len))


def kv_cache_bytes(cfg: ModelConfig, batch: int, seq_len: int) -> float:
    total = 0.0
    for spec in cfg.layers:
        if spec.kind == ATTN:
            span = min(spec.window or seq_len, seq_len)
            total += 2 * span * cfg.kv_dim * BF16
        elif spec.kind == "lru":
            total += cfg.lru_width * (F32 + 3 * BF16)
        else:
            total += (cfg.ssm_heads * cfg.ssm_head_dim * cfg.ssm_state * F32
                      + 3 * (cfg.ssm_inner + 2 * cfg.ssm_state) * BF16)
    if cfg.family == "encdec":
        total += cfg.num_layers * 2 * cfg.prefix_len * cfg.kv_dim * BF16
    return total * batch


# --------------------------------------------------------------- cost model

class CostModel:
    """Per-call time/memory estimates over a cluster.

    ``table`` (a ``core.profiler.ProfileTable`` or anything with the same
    ``lookup_exact``/``add`` duck type) and ``type_scales`` (per-call-type
    multipliers, dimensionless) make the model *calibrated*: measured times
    recorded via ``record_measurement`` override or rescale the analytic
    roofline.  Both default to empty, which reproduces the pure analytic
    model bit-for-bit.
    """

    def __init__(self, cluster: Cluster, profile: Profile | None = None,
                 table=None, type_scales: dict[str, float] | None = None,
                 realloc_scale: float = 1.0):
        self.cluster = cluster
        self.prof = profile or Profile()
        self.table = table
        self.type_scales = dict(type_scales or {})
        # call_type -> [(measured_s, analytic_s)] fed by record_measurement
        self._samples: dict[str, list[tuple[float, float]]] = {}
        # (predicted_s, measured_s) pairs from live ReshardTask timings
        self.realloc_scale = realloc_scale
        self._realloc_samples: list[tuple[float, float]] = []

    # ---- helper bandwidths -------------------------------------------------
    def _tp_bw(self, mesh) -> float:
        return self.cluster.intra_node_bw

    def _dp_bw(self, mesh) -> float:
        # dp/pp usually cross nodes on big meshes
        return (self.cluster.inter_node_bw if mesh.node_count > 1
                else self.cluster.intra_node_bw)

    # ---- per-call estimate ---------------------------------------------------
    def call_cost(self, call: FunctionCall, asg: Assignment) -> CallCost:
        if call.call_type == TRAIN:
            return self._train_cost(call.config, call.workload, asg)
        if call.call_type == INFERENCE:
            return self._inference_cost(call.config, call.workload, asg)
        return self._generate_cost(call.config, call.workload, asg)

    def call_time(self, call: FunctionCall, asg: Assignment) -> float:
        """Estimated wall time of one call in seconds.

        Resolution order (paper §5.1): (1) an exact measured hit for this
        (call type, batch, seq_len, assignment shape) in ``table``; (2) the
        paper's workload-space interpolation — ``ProfileTable.lookup``
        restricted to measurements taken under the *same assignment shape*
        (it needs >= 2 distinct profiled token counts for that shape, so a
        lone measurement never extrapolates wildly and, critically, two
        candidate assignments of one call never collapse onto the same
        interpolated value); (3) the analytic ``CallCost`` total scaled by
        the refitted per-call-type multiplier (1.0 until ``refit`` ran).
        """
        if self.table is not None:
            w, key = call.workload, self._exact_key(call, asg)
            kb, ks = self._table_dims(w)
            hit = self.table.lookup_exact(call.call_type, kb, ks, key)
            if hit is not None:
                return hit
            if hasattr(self.table, "lookup"):
                mid = self.table.lookup(call.call_type, kb, ks,
                                        asg_key=key, min_points=2)
                if mid is not None:
                    return mid
        return (self.call_cost(call, asg).total
                * self.type_scales.get(call.call_type, 1.0))

    @staticmethod
    def _table_dims(w: Workload) -> tuple[int, int]:
        """(batch, seq) dimensions used for table lookups/records.  Packed
        workloads (``total_tokens > 0``) key on (1, total_tokens): the
        packed step's cost is a function of the real token count, so two
        cohorts with equal totals but different max lengths share one
        entry — the honesty contract tested in test_profiler_roofline."""
        if w.total_tokens > 0:
            return 1, w.total_tokens
        return w.batch, w.seq_len

    def _exact_key(self, call: FunctionCall, asg: Assignment) -> str:
        """Exact-hit key for a call: the assignment shape, qualified by the
        call's model name when it differs from the table's family — calls of
        different models with identical workloads (e.g. PPO's reward_inf vs
        ref_inf with distinct configs) must never share measurements."""
        key = assignment_key(asg)
        owner = getattr(self.table, "model_name", None)
        if (call.config is not None and owner is not None
                and call.config.name != owner):
            key = f"{call.config.name}|{key}"
        return key

    def analytic_call_time(self, call: FunctionCall, asg: Assignment) -> float:
        """Calibrated analytic estimate in seconds, *ignoring* exact measured
        hits — what ``call_time`` would return for a congruent but unmeasured
        assignment.  Used to report estimated-vs-measured error."""
        return (self.call_cost(call, asg).total
                * self.type_scales.get(call.call_type, 1.0))

    # ---- measurement feedback (profile -> estimate loop) ---------------------
    def record_measurement(self, call: FunctionCall, asg: Assignment,
                           seconds: float) -> None:
        """Fold one measured call execution (wall seconds) into the model.

        The sample joins the per-call-type pool used by ``refit`` and, when a
        ``table`` is attached, becomes an exact-hit entry for this workload +
        assignment shape.  Calls without a ModelConfig (toy graphs) are
        ignored — no analytic reference exists for them.
        """
        if call.config is None or seconds <= 0.0:
            return
        analytic = self.call_cost(call, asg).total
        self._samples.setdefault(call.call_type, []).append(
            (seconds, analytic))
        if self.table is not None:
            w = call.workload
            # foreign-model calls get a qualified exact-hit key and stay out
            # of the table's interpolation grid (one model family per grid)
            owner = getattr(self.table, "model_name", None)
            kb, ks = self._table_dims(w)
            self.table.add(call.call_type, kb, ks, seconds,
                           asg_key=self._exact_key(call, asg),
                           grid=owner is None or call.config.name == owner)

    def refit(self, min_samples: int = 1) -> dict[str, float]:
        """Recompute ``type_scales`` from recorded measurements.

        Per call type with >= ``min_samples`` samples, the scale is the
        median measured/analytic ratio (dimensionless) — the one-parameter
        analogue of the paper's per-layer profile fit, robust to stragglers.
        ``realloc_scale`` is refit the same way from recorded ``ReshardTask``
        timings.  Returns the updated mapping.
        """
        for ct, samples in self._samples.items():
            if len(samples) < min_samples:
                continue
            ratios = sorted(m / a for m, a in samples if a > 0)
            if ratios:
                self.type_scales[ct] = ratios[len(ratios) // 2]
        if len(self._realloc_samples) >= min_samples:
            ratios = sorted(m / p for p, m in self._realloc_samples if p > 0)
            if ratios:
                self.realloc_scale = ratios[len(ratios) // 2]
        return self.type_scales

    # ---- reallocation (parameter transfer) calibration -----------------------
    def record_realloc(self, predicted_s: float, measured_s: float,
                       nbytes: Optional[float] = None) -> None:
        """Fold one measured reallocation (a completed ``ReshardTask``) into
        the transfer cost model: ``predicted_s`` is the schedule time from
        ``core.realloc.remap_schedule`` for the bytes that actually moved,
        ``measured_s`` the observed dispatch-to-completion wall time.
        Zero-byte (pure-alias) reshards carry no bandwidth information and
        are ignored (pass ``nbytes`` when known; None means unknown)."""
        if predicted_s <= 0.0 or measured_s <= 0.0:
            return
        if nbytes is not None and nbytes <= 0.0:
            return
        self._realloc_samples.append((predicted_s, measured_s))

    def realloc_time(self, sched) -> float:
        """Calibrated duration of a reallocation schedule in seconds — the
        analytic ``Schedule.time`` rescaled by the fitted ratio of measured
        ``ReshardTask`` wall times to their predictions (1.0 uncalibrated)."""
        return sched.time * self.realloc_scale

    def n_measurements(self) -> int:
        """Total recorded measurement samples across call types."""
        return sum(len(v) for v in self._samples.values())

    def _chip(self):
        return self.cluster.chip

    def _layer_comms(self, cfg, s: ParallelStrategy, act_bytes_per_mb, n_passes,
                     mesh, mbs):
        """TP all-reduce + PP p2p time per full pass set."""
        p = self.prof
        t = 0.0
        L = cfg.num_layers + cfg.enc_layers
        if s.tp > 1:
            per_layer = 2 * n_passes  # 2 all-reduces fwd (+2 bwd counted via n_passes)
            wire = hw.all_reduce_bytes(act_bytes_per_mb, s.tp)
            t += (L / s.pp) * per_layer * mbs * (
                wire / self._tp_bw(mesh) * p.comm_scale + p.coll_lat)
        if s.pp > 1:
            hops = (s.pp - 1) * n_passes * mbs
            t += hops * (act_bytes_per_mb / self.cluster.intra_node_bw
                         * p.comm_scale + p.p2p_lat)
        return t

    def _train_cost(self, cfg: ModelConfig, w: Workload, asg: Assignment):
        s, mesh, p = asg.strategy, asg.mesh, self.prof
        if w.total_tokens > 0:
            # packed step: flops/activation terms scale with the real token
            # count — analytically that is the padded formula at the
            # effective per-row length total/batch
            eff = max(1, round(w.total_tokens / max(w.batch, 1)))
            w = dataclasses.replace(w, prompt_len=eff, gen_len=0,
                                    total_tokens=0)
        n_dev = mesh.size
        flops = 3.0 * fwd_flops(cfg, w.batch, w.seq_len)
        compute = flops / (n_dev * self._chip().peak_flops_bf16 * p.eff_train)
        compute *= p.compute_scale
        # HBM: params read+grads written per microbatch pass (weights stream)
        shard = cfg.param_count() * BF16 / (s.tp * s.pp)
        hbm = 3.0 * shard * s.mbs * w.n_minibatches / self._chip().hbm_bw
        hbm *= p.hbm_scale
        # comm: TP/PP per microbatch (fwd+bwd => 3 passes of activations)
        act_mb = w.batch * w.seq_len * cfg.d_model * BF16 / (s.dp * s.mbs)
        comm = self._layer_comms(cfg, s, act_mb, 3, mesh, s.mbs)
        # DP grad all-reduce once per minibatch
        if s.dp > 1:
            grad_bytes = cfg.param_count() * GRAD_BYTES / (s.tp * s.pp)
            comm += (hw.all_reduce_bytes(grad_bytes, s.dp)
                     / self._dp_bw(mesh) * p.comm_scale
                     + p.coll_lat) * w.n_minibatches
        bubble = compute * (s.pp - 1) / max(s.mbs, 1) if s.pp > 1 else 0.0
        return CallCost(compute, hbm, comm, bubble)

    def _inference_cost(self, cfg: ModelConfig, w: Workload, asg: Assignment):
        s, mesh, p = asg.strategy, asg.mesh, self.prof
        flops = fwd_flops(cfg, w.batch, w.seq_len)
        compute = (flops / (mesh.size * self._chip().peak_flops_bf16
                            * p.eff_prefill) * p.compute_scale)
        shard = cfg.param_count() * BF16 / (s.tp * s.pp)
        hbm = shard * s.mbs / self._chip().hbm_bw * p.hbm_scale
        act_mb = w.batch * w.seq_len * cfg.d_model * BF16 / (s.dp * s.mbs)
        comm = self._layer_comms(cfg, s, act_mb, 1, mesh, s.mbs)
        bubble = compute * (s.pp - 1) / max(s.mbs, 1) if s.pp > 1 else 0.0
        return CallCost(compute, hbm, comm, bubble)

    def _generate_cost(self, cfg: ModelConfig, w: Workload, asg: Assignment):
        s, mesh, p = asg.strategy, asg.mesh, self.prof
        chip = self._chip()
        # ---- prefill
        pre = self._inference_cost(
            cfg, Workload(w.batch, w.prompt_len, 0), asg)
        # ---- decode: per step, roofline of (flops, param+cache reads)
        steps = max(w.gen_len, 1)
        flops_step = 2.0 * cfg.active_param_count() * w.batch
        comp = (flops_step / (mesh.size * chip.peak_flops_bf16 * p.eff_decode)
                * p.compute_scale)
        # each stage re-streams its weight shard once per microbatch per step
        param_read = cfg.param_count() * BF16 / (s.tp * s.pp) * s.mbs
        cache_read = kv_cache_bytes(
            cfg, w.batch, w.prompt_len + w.gen_len // 2) / (s.dp * s.tp * s.pp)
        mem = (param_read + cache_read) / chip.hbm_bw * p.hbm_scale
        # per-step TP/PP latency (the paper's Fig. 10 decode observation)
        act = w.batch * cfg.d_model * BF16 / s.dp
        L = cfg.num_layers
        comm_step = 0.0
        if s.tp > 1:
            wire = hw.all_reduce_bytes(act, s.tp)
            comm_step += (L / s.pp) * 2 * (wire / self._tp_bw(mesh)
                                           * p.comm_scale + p.coll_lat)
        if s.pp > 1:
            comm_step += (s.pp - 1) * (act / self.cluster.intra_node_bw
                                       * p.comm_scale + p.p2p_lat)
        decode = steps * (max(comp, mem) + comm_step)
        return CallCost(pre.compute + steps * comp, pre.hbm + steps * mem,
                        pre.comm + steps * comm_step,
                        pre.bubble)

    # ---- speculative decoding (draft-and-verify rollout) ---------------------
    def decode_step_time(self, cfg: ModelConfig, batch: int, ctx_len: int,
                         asg: Assignment, n_positions: int = 1) -> float:
        """Roofline of ONE fused decode/verify dispatch scoring
        ``n_positions`` tokens per sequence.  Compute scales with positions;
        the memory traffic (weight shard + KV read) is position-independent
        — the bandwidth amortization speculative verify exploits: scoring
        k+1 positions costs barely more than one while decode is
        memory-bound."""
        s, mesh, p = asg.strategy, asg.mesh, self.prof
        chip = self._chip()
        flops = 2.0 * cfg.active_param_count() * batch * n_positions
        comp = (flops / (mesh.size * chip.peak_flops_bf16 * p.eff_decode)
                * p.compute_scale)
        param_read = cfg.param_count() * BF16 / (s.tp * s.pp) * s.mbs
        cache_read = kv_cache_bytes(cfg, batch, ctx_len) / (s.dp * s.tp * s.pp)
        mem = (param_read + cache_read) / chip.hbm_bw * p.hbm_scale
        act = batch * n_positions * cfg.d_model * BF16 / s.dp
        comm = 0.0
        if s.tp > 1:
            wire = hw.all_reduce_bytes(act, s.tp)
            comm += (cfg.num_layers / s.pp) * 2 * (
                wire / self._tp_bw(mesh) * p.comm_scale + p.coll_lat)
        if s.pp > 1:
            comm += (s.pp - 1) * (act / self.cluster.intra_node_bw
                                  * p.comm_scale + p.p2p_lat)
        return max(comp, mem) + comm

    def spec_cycle_time(self, target_cfg: ModelConfig,
                        draft_cfg: ModelConfig, batch: int, ctx_len: int,
                        k: int, asg: Assignment,
                        draft_asg: Assignment) -> float:
        """One draft-and-verify cycle: k+1 draft decode dispatches (the last
        is the consume-only catch-up step) + one target verify dispatch
        scoring k+1 positions."""
        draft_t = (k + 1) * self.decode_step_time(draft_cfg, batch, ctx_len,
                                                  draft_asg)
        verify_t = self.decode_step_time(target_cfg, batch, ctx_len, asg,
                                         n_positions=k + 1)
        return draft_t + verify_t

    def spec_cycle_time_fn(self, target_cfg: ModelConfig,
                           draft_cfg: ModelConfig, batch: int, ctx_len: int,
                           asg: Assignment, draft_asg: Assignment):
        """``k -> seconds`` closure binding this calibrated model — plugs
        directly into ``models.spec.SpecController(cycle_cost=...)`` so the
        rollout's adaptive draft length is driven by the same estimator
        that placed both models."""
        return lambda k: self.spec_cycle_time(target_cfg, draft_cfg, batch,
                                              ctx_len, k, asg, draft_asg)

    # accept-rate feedback: measured per-model EMAs, mirroring
    # record_measurement for wall times
    def record_accept_rate(self, model_name: str, rate: float,
                           decay: float = 0.9) -> None:
        """Fold one rollout's measured draft accept rate into the per-model
        EMA that ``spec_generate_time``/``optimal_spec_k`` consume."""
        rate = min(max(float(rate), 0.0), 1.0)
        if not hasattr(self, "_accept_rates"):
            self._accept_rates: dict[str, float] = {}
        prev = self._accept_rates.get(model_name)
        self._accept_rates[model_name] = (
            rate if prev is None else decay * prev + (1.0 - decay) * rate)

    def accept_rate(self, model_name: str, default: float = 0.7) -> float:
        return getattr(self, "_accept_rates", {}).get(model_name, default)

    def spec_generate_time(self, call: FunctionCall, asg: Assignment,
                           draft_cfg: ModelConfig, draft_asg: Assignment, *,
                           k: int, accept_rate: float | None = None) -> float:
        """Estimated wall time of a GENERATE call executed speculatively:
        both prefills + enough cycles to commit ``gen_len`` tokens at the
        truncated-geometric expectation of rejection sampling."""
        w = call.workload
        a = (accept_rate if accept_rate is not None
             else self.accept_rate(call.model_name))
        per_cycle = spec_expected_committed(a, k)
        cycles = max(w.gen_len, 1) / per_cycle
        ctx = w.prompt_len + w.gen_len // 2
        cyc = self.spec_cycle_time(call.config, draft_cfg, w.batch, ctx, k,
                                   asg, draft_asg)
        pre = self._inference_cost(
            call.config, Workload(w.batch, w.prompt_len, 0), asg).total
        dpre = self._inference_cost(
            draft_cfg, Workload(w.batch, w.prompt_len, 0), draft_asg).total
        return pre + dpre + cycles * cyc

    def optimal_spec_k(self, call: FunctionCall, asg: Assignment,
                       draft_cfg: ModelConfig, draft_asg: Assignment, *,
                       k_max: int = 8,
                       accept_rate: float | None = None) -> int:
        """Draft length minimizing the estimated speculative rollout time
        (includes k=1; callers compare against the non-speculative
        ``call_time`` separately to decide whether to speculate at all)."""
        return min(range(1, k_max + 1),
                   key=lambda k: self.spec_generate_time(
                       call, asg, draft_cfg, draft_asg, k=k,
                       accept_rate=accept_rate))

    # ---- memory --------------------------------------------------------------
    def static_mem_per_dev(self, cfg: ModelConfig, asg: Assignment,
                           opt_shard_dp: bool = True) -> float:
        """Optimizer states + fp32 masters + grads that stay resident on the
        train-call mesh for the whole experiment."""
        n = cfg.param_count()
        denom = asg.strategy.size if opt_shard_dp else (
            asg.strategy.tp * asg.strategy.pp)
        return (n * ADAM_BYTES) / denom + n * GRAD_BYTES / (
            asg.strategy.tp * asg.strategy.pp)

    def active_mem_per_dev(self, call: FunctionCall, asg: Assignment) -> float:
        cfg, w, s = call.config, call.workload, asg.strategy
        params = cfg.param_count() * BF16 / (s.tp * s.pp)
        act_tokens = w.batch * w.seq_len / (s.dp * s.mbs)
        if call.call_type == TRAIN:
            # remat: layer-boundary activations + working set + logits
            acts = act_tokens * cfg.d_model * BF16 * (
                (cfg.num_layers + cfg.enc_layers) / s.pp + 8)
            logits = act_tokens * cfg.vocab_size * F32 / s.tp
            return params + acts + logits
        if call.call_type == INFERENCE:
            acts = act_tokens * cfg.d_model * BF16 * 8
            logits = act_tokens * cfg.vocab_size * F32 / s.tp / (
                cfg.num_layers / s.pp)  # only last stage holds logits
            return params + acts + logits
        cache = kv_cache_bytes(cfg, w.batch, w.seq_len) / (s.dp * s.tp * s.pp)
        acts = w.batch * w.prompt_len / (s.dp * s.mbs) * cfg.d_model * BF16 * 4
        return params + cache + acts
