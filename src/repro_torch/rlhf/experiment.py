"""The PPO experiment's models and executors, the part of the JAX package's
``rlhf/experiment.py`` that runs one model function call each: the
actor's generation, reference, critic and reward inference, and the actor
and critic train steps, padded (the default) or packed.

The JAX package's ``RLHFExperiment`` also searches an execution plan and
drives the calls through its ``RuntimeEngine`` with parameter
reallocation; neither is ported yet.  Here a caller runs the executors in
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
package).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data import packing
from repro_torch.kernels import ops as OPS
from repro_torch.models import model as MDL
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.rlhf import ppo as PPO
from repro_torch.rlhf import reward as RWD


@dataclasses.dataclass
class ExperimentConfig:
    """The JAX package's ``ExperimentConfig`` fields that the executors
    read.  ``impl`` is the kernel tier of inference and training,
    ``rollout_impl`` (None: ``impl``) that of generation."""
    batch: int = 8
    prompt_len: int = 16
    gen_len: int = 16
    seed: int = 0
    ppo: PPO.PPOHyperparameters = dataclasses.field(default_factory=PPO.PPOHyperparameters)
    opt: adamw.AdamWConfig = dataclasses.field(default_factory=adamw.AdamWConfig)
    impl: str = "cuda"
    rollout_impl: Optional[str] = None
    fused_sampling: bool = True
    eos_id: Optional[int] = None
    top_k: int = 0
    top_p: float = 1.0
    packed_training: bool = False
    draft_model: Optional[ModelConfig] = None


@dataclasses.dataclass
class ModelState:
    """A model's parameters and, for a trained model, its AdamW state."""
    params: Any
    opt_state: Any = None


def build_models(actor_cfg: ModelConfig, critic_cfg: ModelConfig, exp: ExperimentConfig, *,
                 device="cuda") -> dict:
    """The four PPO models with seeded random weights: actor and reference
    from one seed (as the JAX package draws both from one key), critic and
    reward value models from two others.  The trained models' parameters
    require grad and get AdamW state."""
    models = {
        "actor": ModelState(MDL.init_params(actor_cfg, seed=exp.seed, device=device)),
        "ref": ModelState(MDL.init_params(actor_cfg, seed=exp.seed, device=device)),
        "critic": ModelState(MDL.init_params(critic_cfg, seed=exp.seed + 2, device=device,
                                             head="value")),
        "reward": ModelState(MDL.init_params(critic_cfg, seed=exp.seed + 3, device=device,
                                             head="value")),
    }
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
                    exp: ExperimentConfig) -> dict:
    """The executors of the six PPO function calls, each
    f(model_state, inputs) -> outputs, as the JAX package's
    ``_build_executors`` makes them.  Inference runs under
    ``torch.no_grad()`` without remat; a train call updates the model state
    in place and returns its stats as floats."""
    if exp.packed_training:
        for cfg in (actor_cfg, critic_cfg):
            T.check_packed(cfg)
    if exp.draft_model is not None:
        raise NotImplementedError("speculative rollout (draft_model) is not ported")
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

    return {"actor_gen": actor_gen, "reward_inf": reward_inf, "ref_inf": ref_inf,
            "critic_inf": critic_inf, "actor_train": actor_train,
            "critic_train": critic_train}
