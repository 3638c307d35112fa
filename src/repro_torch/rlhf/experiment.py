"""User-facing experiment API (paper Appendix B, Fig. 18), the port's copy
of the JAX package's ``rlhf/experiment.py``.

``RLHFExperiment`` builds the PPO dataflow graph, searches an execution
plan on a ``Cluster`` (MCMC, or the heuristic), calibrates the cost model
from a ``ProfileStore`` when one is given, builds the four models and the
executors of the six function calls, and runs PPO iterations through
``core.runtime.RuntimeEngine``, barriered (``run_iteration``) or pipelined
(``run(steps=k)`` with ``pipeline_depth`` iterations in flight).  Its
entry points run on the card unless the caller passes ``device="cpu"``;
reallocation is logical (``core/runtime.py`` says why).

The executors are also usable alone, which is how the engine calls them:
each is f(model_state, inputs) -> outputs, and a caller can run them in
dataflow order itself:

    models = build_models(actor_cfg, critic_cfg, exp)
    ex = build_executors(actor_cfg, critic_cfg, exp)
    roll = ex["actor_gen"](models["actor"], {"prompts": {"tokens": prompts}})
    roll |= ex["ref_inf"](models["ref"], roll)
    roll |= ex["critic_inf"](models["critic"], roll)
    roll |= ex["reward_inf"](models["reward"], roll)
    ex["actor_train"](models["actor"], roll)
    ex["critic_train"](models["critic"], roll)

Padded training (``packed_training=False``) trains every model the port
serves; packed training takes attention-only models, dense or MoE (a
recurrent mixer would scan across the packed sequences, as in the JAX
package).  With ``draft_model`` set the rollout is speculative
(``models/spec.py``): ``actor_gen`` drafts with the frozen draft and
verifies (``build_executors(..., draft=models["draft"])``), a seventh call,
``draft_gen``, orders the two models in the plan, and the measured accept
rate goes back into the cost model.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import dfg as DFG
from repro_torch.core import fault as FLT
from repro_torch.core.estimator import CostModel
from repro_torch.core.plan import Cluster, ExecutionPlan
from repro_torch.core.runtime import ModelState, RuntimeEngine
from repro_torch.core.search import heuristic_plan, mcmc_search
from repro_torch.data import packing
from repro_torch.kernels import ops as OPS
from repro_torch.models import model as MDL
from repro_torch.models import spec as SPEC
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.rlhf import ppo as PPO
from repro_torch.rlhf import reward as RWD


@dataclasses.dataclass
class ExperimentConfig:
    """The JAX package's ``ExperimentConfig`` fields that the port reads
    (their comments there say more).  ``impl`` is the kernel tier of
    inference and training, ``rollout_impl`` (None: ``impl``) that of
    generation."""
    batch: int = 8
    prompt_len: int = 16
    gen_len: int = 16
    seed: int = 0
    ppo: PPO.PPOHyperparameters = dataclasses.field(default_factory=PPO.PPOHyperparameters)
    opt: adamw.AdamWConfig = dataclasses.field(default_factory=adamw.AdamWConfig)
    search_iters: int = 300
    impl: str = "cuda"
    rollout_impl: Optional[str] = None
    fused_sampling: bool = True
    eos_id: Optional[int] = None
    top_k: int = 0
    top_p: float = 1.0
    # launch/serve.build_server's engine: "bucketed" or "continuous" (paged KV)
    serve_mode: str = "continuous"
    max_kv_blocks: int = 0  # total pool blocks (0 = worst-case auto-size)
    # checkpoint every N retired iterations through checkpoint/manager.py
    checkpoint_every: int = 0
    checkpoint_dir: Optional[str] = None
    # a core/profiler.ProfileStore JSON: with an entry for the actor on this
    # hardware the plan search runs on its calibrated CostModel
    profile_path: Optional[str] = None
    # fold live CallRecords back into the cost model every N calls (0 = off)
    recalibrate_every: int = 0
    # iterations of the concatenated dataflow graph in flight in run(steps=k)
    pipeline_depth: int = 1
    retry: FLT.RetryPolicy = dataclasses.field(default_factory=FLT.RetryPolicy)
    max_recoveries: int = 2
    replan_iters: int = 60
    speculative_redispatch: bool = False
    packed_training: bool = False
    # speculative rollout: a frozen draft proposes spec_k tokens per cycle
    # (re-picked per cycle when spec_adaptive), on a block pool of
    # kv_block_size-token blocks; attention-only, one vocabulary, no eos_id
    draft_model: Optional[ModelConfig] = None
    spec_k: int = 4
    spec_adaptive: bool = True
    kv_block_size: int = 16


def build_models(actor_cfg: ModelConfig, critic_cfg: ModelConfig, exp: ExperimentConfig, *,
                 device="cuda") -> dict:
    """The four PPO models with seeded random weights: actor and reference
    from one seed (as the JAX package draws both from one key), critic and
    reward value models from two others; a draft model, when ``exp`` has
    one, from a fourth (frozen: no grad, no optimizer state).  The trained
    models' parameters require grad and get AdamW state."""
    models = {
        "actor": ModelState(MDL.init_params(actor_cfg, seed=exp.seed, device=device)),
        "ref": ModelState(MDL.init_params(actor_cfg, seed=exp.seed, device=device)),
        "critic": ModelState(MDL.init_params(critic_cfg, seed=exp.seed + 2, device=device,
                                             head="value")),
        "reward": ModelState(MDL.init_params(critic_cfg, seed=exp.seed + 3, device=device,
                                             head="value")),
    }
    if exp.draft_model is not None:
        models["draft"] = ModelState(MDL.init_params(exp.draft_model, seed=exp.seed + 17,
                                                     device=device))
    for name in ("actor", "critic"):
        ms = models[name]
        for p in adamw.leaves(ms.params):
            p.requires_grad_(True)
        ms.opt_state = adamw.init(exp.opt, ms.params)
    return models


def max_seqlen(exp: ExperimentConfig) -> int:
    """The longest packed sequence: the prompt and every generated token."""
    return exp.prompt_len + exp.gen_len


def _packed_prep(exp: ExperimentConfig, inputs):
    """Repack a padded rollout: per-sequence lengths (keeping one post-EOS
    bootstrap token: GAE parity needs the carry entering the last valid
    token to be -V of its position), token-aligned (B, S) per-token
    tensors, and the packed advantages and returns from the (T,) PPO
    math.  Returns (lens, S, logp_full, mask_full, adv, ret)."""
    hp, P, G = exp.ppo, exp.prompt_len, exp.gen_len
    g_valid = inputs["gen_mask"].sum(-1).cpu().numpy().astype(np.int64)
    lens = P + np.minimum(g_valid + 1, G)
    seq = inputs["seq"]
    b, s = seq.shape
    full = {}
    for name, src, lo in (("logp", "logp", P), ("ref", "ref_logp", P),
                          ("mask", "gen_mask", P), ("values", "values", P - 1)):
        full[name] = torch.zeros((b, s), dtype=torch.float32, device=seq.device)
        full[name][:, lo:] = inputs[src]
    cu = torch.from_numpy(packing.cu_seqlens_of(lens)).to(seq.device)
    m_p = packing.pack(full["mask"], lens)
    v_p = packing.pack(full["values"], lens)
    shaped = PPO.shaped_rewards_packed(hp, inputs["rewards"], packing.pack(full["logp"], lens),
                                       packing.pack(full["ref"], lens), m_p, cu)
    adv, ret = PPO.gae_packed(hp, shaped, PPO.packed_shift_right(v_p), v_p, m_p, cu)
    return lens, s, full["logp"], full["mask"], adv, ret


def _padded_prep(exp: ExperimentConfig, inputs):
    """The padded advantages and returns of a rollout, as the JAX package's
    padded ``actor_train`` / ``critic_train``: shaped rewards, then GAE
    over the (B, G) generated region."""
    hp, mask = exp.ppo, inputs["gen_mask"]
    shaped = PPO.shaped_rewards(hp, inputs["rewards"], inputs["logp"], inputs["ref_logp"],
                                mask)
    return PPO.gae(hp, shaped, inputs["values"], mask)


@torch.no_grad()
def actor_train_batch(exp: ExperimentConfig, inputs) -> dict:
    """The actor's train batch of one rollout: padded, (B, ...) tensors
    that the step splits into minibatches; or packed, the
    ``pack_minibatches`` minibatches."""
    if not exp.packed_training:
        adv, _ = _padded_prep(exp, inputs)
        return {"tokens": inputs["seq"], "logp": inputs["logp"], "adv": adv,
                "mask": inputs["gen_mask"]}
    lens, s, logp_full, mask_full, adv, _ = _packed_prep(exp, inputs)
    return packing.pack_minibatches(
        inputs["seq"], {"logp": logp_full, "adv": packing.unpack(adv, lens, s),
                        "mask": mask_full},
        lens, exp.ppo.n_minibatches, max_seqlen=max_seqlen(exp))


@torch.no_grad()
def critic_train_batch(exp: ExperimentConfig, inputs) -> dict:
    """The critic's train batch of one rollout, as :func:`actor_train_batch`
    with the old values (packed: target-aligned) and returns."""
    if not exp.packed_training:
        _, ret = _padded_prep(exp, inputs)
        return {"tokens": inputs["seq"], "values": inputs["values"][:, :-1], "ret": ret,
                "mask": inputs["gen_mask"]}
    lens, s, _, mask_full, _, ret = _packed_prep(exp, inputs)
    old_full = torch.zeros_like(mask_full)
    old_full[:, exp.prompt_len:] = inputs["values"][:, :-1]
    return packing.pack_minibatches(
        inputs["seq"], {"values": old_full, "ret": packing.unpack(ret, lens, s),
                        "mask": mask_full},
        lens, exp.ppo.n_minibatches, max_seqlen=max_seqlen(exp))


def build_executors(actor_cfg: ModelConfig, critic_cfg: ModelConfig,
                    exp: ExperimentConfig, *, draft: Optional[ModelState] = None,
                    cost: Optional[CostModel] = None,
                    controller: Optional[SPEC.SpecController] = None) -> dict:
    """The executors of the six PPO function calls, each
    f(model_state, inputs) -> outputs, as the JAX package's
    ``_build_executors`` makes them.  Inference runs under
    ``torch.no_grad()`` without remat; a train call updates the model state
    in place and returns its stats as floats.

    With ``exp.draft_model``, ``actor_gen`` rolls out through
    ``spec_generate`` with ``draft`` (the draft's model state, required),
    re-picking k per cycle with ``controller`` (None: a fixed
    ``exp.spec_k``), and records each rollout's accept rate in ``cost``
    when given; a seventh executor, ``draft_gen``, only publishes the
    dependency token the plan orders the two calls by."""
    if exp.packed_training:
        for cfg in (actor_cfg, critic_cfg):
            T.check_packed(cfg)
    if exp.draft_model is not None:
        SPEC.check_spec_pair(actor_cfg, exp.draft_model)
        if draft is None:
            raise ValueError("a draft_model experiment's executors need the draft's "
                             "model state (draft=)")
    if not exp.fused_sampling:
        raise NotImplementedError("the port's generate is the fused decode-and-sample "
                                  "loop only")
    impl, rollout_impl = exp.impl, exp.rollout_impl or exp.impl
    for tier in (impl, rollout_impl):
        if tier not in OPS.IMPLS:
            raise ValueError(f"impl={tier!r} not in {OPS.IMPLS}")
    hp, P = exp.ppo, exp.prompt_len
    state = {"gen": None}
    if exp.packed_training:
        actor_step = PPO.make_packed_actor_train_step(actor_cfg, hp, exp.opt, impl=impl,
                                                      max_seqlen=max_seqlen(exp))
        critic_step = PPO.make_packed_critic_train_step(critic_cfg, hp, exp.opt, impl=impl,
                                                        max_seqlen=max_seqlen(exp))
    else:
        actor_step = PPO.make_actor_train_step(actor_cfg, hp, exp.opt, P, impl=impl)
        critic_step = PPO.make_critic_train_step(critic_cfg, hp, exp.opt, P, impl=impl)

    def actor_gen(ms, inputs):
        prompts = inputs["prompts"]["tokens"]
        if state["gen"] is None:
            state["gen"] = torch.Generator(device=prompts.device).manual_seed(exp.seed + 1)
        out = MDL.generate(ms.params, actor_cfg, inputs["prompts"],
                           num_new_tokens=exp.gen_len, rng=state["gen"],
                           impl=rollout_impl, eos_id=exp.eos_id, top_k=exp.top_k,
                           top_p=exp.top_p)
        seq = torch.cat([prompts, out["tokens"].to(prompts.dtype)], dim=1)
        mask = out.get("gen_mask", torch.ones_like(out["logprobs"]))
        return {"seq": seq, "logp": out["logprobs"], "gen_mask": mask}

    def draft_gen(ms, inputs):
        # the plan places the draft and costs its steps; at run time its
        # proposals are interleaved with the verify steps in actor_gen, so
        # this call only publishes the dependency token
        prompts = inputs["prompts"]["tokens"]
        return {"draft_seq": torch.zeros(prompts.shape[0], dtype=torch.int32,
                                         device=prompts.device)}

    def actor_gen_spec(ms, inputs):
        prompts = inputs["prompts"]["tokens"]
        if state["gen"] is None:
            state["gen"] = torch.Generator(device=prompts.device).manual_seed(exp.seed + 1)
        out = SPEC.spec_generate(ms.params, actor_cfg, draft.params, exp.draft_model,
                                 inputs["prompts"], num_new_tokens=exp.gen_len,
                                 spec_k=exp.spec_k, rng=state["gen"], top_k=exp.top_k,
                                 top_p=exp.top_p, impl=rollout_impl,
                                 block_size=exp.kv_block_size, controller=controller)
        if cost is not None:  # the measured accept rate closes the estimator's loop
            cost.record_accept_rate("actor", out["stats"]["accept_rate"])
        seq = torch.cat([prompts, out["tokens"].to(prompts.dtype)], dim=1)
        return {"seq": seq, "logp": out["logprobs"],
                "gen_mask": torch.ones_like(out["logprobs"]), "spec_stats": out["stats"]}

    @torch.no_grad()
    def reward_inf(ms, inputs):
        full_mask = torch.ones(inputs["seq"].shape, dtype=torch.float32,
                               device=inputs["seq"].device)
        return {"rewards": RWD.score_sequences(ms.params, critic_cfg, inputs["seq"],
                                               full_mask, impl=impl)}

    @torch.no_grad()
    def ref_inf(ms, inputs):
        return {"ref_logp": PPO.sequence_logprobs(ms.params, actor_cfg, inputs["seq"], P,
                                                  impl=impl, remat=False)}

    @torch.no_grad()
    def critic_inf(ms, inputs):
        return {"values": PPO.sequence_values(ms.params, critic_cfg, inputs["seq"], P,
                                              impl=impl, remat=False)}

    def actor_train(ms, inputs):
        batch = actor_train_batch(exp, inputs)
        ms.params, ms.opt_state, stats = actor_step(ms.params, ms.opt_state, batch)
        return {"actor_stats": {k: float(v) for k, v in stats.items()}}

    def critic_train(ms, inputs):
        batch = critic_train_batch(exp, inputs)
        ms.params, ms.opt_state, stats = critic_step(ms.params, ms.opt_state, batch)
        return {"critic_stats": {k: float(v) for k, v in stats.items()}}

    executors = {"actor_gen": actor_gen, "reward_inf": reward_inf, "ref_inf": ref_inf,
                 "critic_inf": critic_inf, "actor_train": actor_train,
                 "critic_train": critic_train}
    if exp.draft_model is not None:
        executors.update(actor_gen=actor_gen_spec, draft_gen=draft_gen)
    return {name: _on_model_device(fn) for name, fn in executors.items()}


def _on_model_device(fn):
    """``fn(ms, inputs)`` with the model's CUDA device current: the engine
    runs executors in pool threads, and torch keeps the current device per
    thread."""
    @functools.wraps(fn)
    def run(ms, inputs):
        dev = adamw.leaves(ms.params)[0].device
        if dev.type != "cuda":
            return fn(ms, inputs)
        with torch.cuda.device(dev):
            return fn(ms, inputs)
    return run


class RLHFExperiment:
    """PPO experiment: 4 models, 6 function calls, a searched execution
    plan, run by ``RuntimeEngine`` (the JAX package's class).  The models
    and executors live on ``device`` ("cuda" by default; "cpu" with
    ``impl="reference"`` for the CPU tests)."""

    def __init__(self, actor_cfg: ModelConfig, critic_cfg: ModelConfig, cluster: Cluster,
                 exp: ExperimentConfig, plan: Optional[ExecutionPlan] = None,
                 search: bool = True, fault_injector: Optional[FLT.FaultInjector] = None,
                 device="cuda"):
        self.actor_cfg, self.critic_cfg, self.exp = actor_cfg, critic_cfg, exp
        self.cluster = cluster
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("RLHFExperiment(device='cuda'): no CUDA device is available; "
                               "pass device='cpu' (with impl='reference') to run on the host")
        if exp.packed_training:
            from repro_torch.analysis.verify import packed_mixer_error
            for cfg in (actor_cfg, critic_cfg):
                msg = packed_mixer_error(cfg)
                if msg:
                    raise ValueError(msg)
        if exp.draft_model is not None:
            SPEC.check_spec_pair(actor_cfg, exp.draft_model)  # fail at construction
            if exp.eos_id is not None:
                raise ValueError("eos_id early exit is not supported on the speculative "
                                 "rollout path; unset draft_model or eos_id")
        self.graph = DFG.build_ppo(
            actor_cfg, critic_cfg, batch=exp.batch, prompt_len=exp.prompt_len,
            gen_len=exp.gen_len, n_minibatches=exp.ppo.n_minibatches,
            packed=exp.packed_training, draft=exp.draft_model)
        self.cost = CostModel(cluster)
        self.profile_store = None
        if exp.profile_path:
            from repro_torch.core.profiler import ProfileStore, ProfileTable
            self.profile_store = ProfileStore(exp.profile_path)
            entry = self.profile_store.get(actor_cfg.name)
            if entry is not None:
                self.cost = entry.cost_model(cluster)
            else:  # attach an empty table so live records accumulate into it
                self.cost.table = ProfileTable(actor_cfg.name, {})
        if plan is None:
            if search:
                plan = mcmc_search(self.graph, cluster, self.cost, iters=exp.search_iters,
                                   seed=exp.seed,
                                   pipeline_iters=max(exp.pipeline_depth, 1)).best_plan
            else:
                plan = heuristic_plan(self.graph, cluster, self.cost)
        self.plan = plan
        # the trainable set, from the dataflow graph's TRAIN calls
        self._trainable = tuple(sorted({c.model_name for c in self.graph.calls
                                        if c.call_type == DFG.TRAIN}))
        self.models = build_models(actor_cfg, critic_cfg, exp, device=self.device)
        self.spec_controller = None
        if exp.draft_model is not None and exp.spec_adaptive:
            # drive k from the estimator that placed both models, when the
            # plan says where they sit
            a_asg = self.plan.assignments.get("actor_gen")
            d_asg = self.plan.assignments.get("draft_gen")
            cycle_cost = None
            if a_asg is not None and d_asg is not None:
                cycle_cost = self.cost.spec_cycle_time_fn(
                    actor_cfg, exp.draft_model, exp.batch, exp.prompt_len + exp.gen_len // 2,
                    a_asg, d_asg)
            self.spec_controller = SPEC.SpecController(init_k=exp.spec_k,
                                                       cycle_cost=cycle_cost)
        self.executors = build_executors(actor_cfg, critic_cfg, exp,
                                         draft=self.models.get("draft"), cost=self.cost,
                                         controller=self.spec_controller)
        candidates = []
        if exp.recalibrate_every > 0:
            try:  # the symmetric baseline is the natural fallback candidate
                candidates.append(heuristic_plan(self.graph, cluster, self.cost))
            except ValueError:
                pass
        self.engine = RuntimeEngine(self.graph, self.plan, self.executors, self.models,
                                    cost_model=self.cost,
                                    pipeline_depth=exp.pipeline_depth,
                                    recalibrate_every=exp.recalibrate_every,
                                    plan_candidates=candidates,
                                    retry_policy=exp.retry,
                                    fault_injector=fault_injector,
                                    replanner=self._replan_on_topology,
                                    restore_models=self._restore_lost,
                                    max_recoveries=exp.max_recoveries,
                                    speculative_redispatch=exp.speculative_redispatch,
                                    # actor_gen advances a stateful generator:
                                    # only inference is idempotent
                                    speculative_types=(DFG.INFERENCE,))
        self.iteration = 0
        self.ckpt = None
        if exp.checkpoint_every > 0:
            from repro_torch.checkpoint.manager import CheckpointManager
            self.ckpt = CheckpointManager(exp.checkpoint_dir or "checkpoints")

    # ------------------------------------------------------------ running
    def make_prompts(self, rng) -> dict:
        """(batch, prompt_len) random prompt tokens drawn from ``rng`` (a
        seed or a ``torch.Generator`` on the host, so a seed gives the same
        prompts on every device)."""
        toks = torch.randint(0, self.actor_cfg.vocab_size,
                             (self.exp.batch, self.exp.prompt_len), generator=_generator(rng))
        return {"tokens": toks.to(self.device)}

    def run_iteration(self, rng) -> dict:
        """One barriered PPO iteration on prompts from ``rng``; returns its
        data pool."""
        out = self.engine.run_iteration({"prompts": self.make_prompts(rng)})
        self.iteration += 1
        if self.ckpt and self.iteration % self.exp.checkpoint_every == 0:
            self.save_checkpoint()
        return out

    def run(self, rng, steps: int) -> list[dict]:
        """``steps`` PPO iterations through the pipelined runtime
        (``pipeline_depth`` in flight; depth 1 reproduces ``run_iteration``
        in a loop).  Iteration t's prompts come from a generator of its
        own, seeded with the t-th draw from ``rng`` (a seed or a
        generator).  Returns the per-iteration data pools in order.
        Checkpoints are taken at retirement, with the executors
        quiesced."""
        seeds = torch.randint(0, 2**62, (max(steps, 1),), generator=_generator(rng)).tolist()

        def data_for(t):
            return {"prompts": self.make_prompts(seeds[t])}

        def on_retire(t, pool):
            self.iteration += 1
            if self.ckpt and self.iteration % self.exp.checkpoint_every == 0:
                self.save_checkpoint()

        return self.engine.run(data_for, steps=steps, on_retire=on_retire,
                               quiesce_on_retire=self.ckpt is not None)

    # ------------------------------------------------------------ elasticity
    def _replan_on_topology(self, cluster: Cluster, event) -> ExecutionPlan:
        """Engine callback on a topology change (host loss or gain): a
        short MCMC on the resized cluster, seeded with the old plan's
        projection so surviving assignments tend to stay put."""
        from repro_torch.core.search import replan_on_topology
        notice = getattr(event, "kind", None) == "notice"
        plan = replan_on_topology(
            self.graph, cluster, self.cost, base_plan=self.plan,
            iters=self.exp.replan_iters, seed=self.exp.seed,
            pipeline_iters=max(self.exp.pipeline_depth, 1),
            avoid_nodes=tuple(event.nodes) if notice else ())
        if not notice:
            # a notice plans on the SAME cluster (the doomed host is
            # excluded, not renumbered away); loss and gain resize it
            self.cluster = cluster
        self.plan = plan
        return plan

    def _restore_lost(self, lost: list[str]):
        """Engine fallback when a model lost every replica: restore just
        those models (and their opt states) from the newest valid
        checkpoint."""
        if self.ckpt is None:
            raise RuntimeError(
                f"models {lost} lost every replica and no checkpointing is "
                "configured (set ExperimentConfig.checkpoint_every)")
        template = {}
        for name in lost:
            template[name] = self.models[name].params
            if name in self._trainable:
                template[f"{name}_opt"] = self.models[name].opt_state
        self.ckpt.wait()
        _step, trees, _extra = self.ckpt.restore(template)
        for name in lost:
            self.models[name].params = trees[name]
            if f"{name}_opt" in trees:
                self.models[name].opt_state = trees[f"{name}_opt"]

    # ---------------------------------------------------------- calibration
    def save_profile(self) -> None:
        """Persist the (possibly runtime-refitted) calibrated cost model
        back into the profile store; a no-op without ``profile_path``."""
        if self.profile_store is None:
            return
        self.profile_store.put_cost_model(self.actor_cfg.name, self.cost)
        self.profile_store.save()

    # -------------------------------------------------------- checkpointing
    def _checkpoint_trees(self) -> dict:
        trees = {name: ms.params for name, ms in self.models.items()}
        for name in self._trainable:
            trees[f"{name}_opt"] = self.models[name].opt_state
        return trees

    def save_checkpoint(self):
        """Snapshot all four models (and the trained ones' opt states) to
        host memory; the manager writes them in the background."""
        self.ckpt.save_async(self.iteration, self._checkpoint_trees(),
                             extra={"iteration": self.iteration})

    def restore_checkpoint(self, step: Optional[int] = None) -> int:
        """Load the latest (or a specific) checkpoint back into the live
        ``ModelState``s; returns the restored iteration number."""
        self.ckpt.wait()
        step, trees, extra = self.ckpt.restore(self._checkpoint_trees(), step)
        for name, ms in self.models.items():
            ms.params = trees[name]
        for name in self._trainable:
            self.models[name].opt_state = trees[f"{name}_opt"]
        self.iteration = int(extra.get("iteration", step))
        return self.iteration


def _generator(rng) -> torch.Generator:
    """``rng`` itself when it is a ``torch.Generator``, else a host
    generator seeded with it."""
    if isinstance(rng, torch.Generator):
        return rng
    return torch.Generator().manual_seed(int(rng))
