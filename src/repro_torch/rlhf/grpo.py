"""GRPO (paper §8.3), as the JAX package's ``rlhf/grpo.py``: grouped
generation, group-relative advantages, no critic.  The workload multiplies
the generation batch by ``group_size``, which makes PPO-style training
more compute-bound (the paper's Fig. 16 observation)."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.optim import adamw
from repro_torch.rlhf.ppo import _loss_grads, _one_update, actor_loss_fn, sequence_logprobs


@dataclasses.dataclass(frozen=True)
class GRPOHyperparameters:
    group_size: int = 8
    clip_eps: float = 0.2
    kl_coef: float = 0.04
    n_minibatches: int = 1


def group_advantages(rewards, group_size: int):
    """rewards: (B * G,), each group of G rows consecutive.  Returns them
    whitened within each group by its mean and population std (jnp's
    ``std``, ``correction=0``)."""
    r = rewards.reshape(-1, group_size)
    mean = r.mean(-1, keepdim=True)
    std = r.std(-1, correction=0, keepdim=True) + 1e-6
    return ((r - mean) / std).reshape(-1)


def grpo_grads(params, cfg, hp: GRPOHyperparameters, batch, gen_start: int, *,
               impl="cuda"):
    """Loss, stats and gradients (one per ``adamw.leaves(params)``) of the
    GRPO loss on ``batch`` (as :func:`make_grpo_train_step` takes it): the
    clipped surrogate on the group advantages plus ``kl_coef`` times the k3
    estimate of KL(policy || ref) per valid token."""
    adv = group_advantages(batch["rewards"], hp.group_size)[:, None] * batch["mask"]

    def loss_fn(p):
        new_logp = sequence_logprobs(p, cfg, batch["tokens"], gen_start, impl=impl)
        loss, stats = actor_loss_fn(hp, new_logp, batch["logp"], adv, batch["mask"])
        lr = batch["ref_logp"] - new_logp
        kl = (torch.exp(lr) - lr - 1.0) * batch["mask"]
        n = torch.clamp(batch["mask"].sum(), min=1.0)
        return loss + hp.kl_coef * kl.sum() / n, stats
    return _loss_grads(params, loss_fn)


def make_grpo_train_step(cfg, hp: GRPOHyperparameters, opt: adamw.AdamWConfig,
                         gen_start: int, *, impl="cuda"):
    """Returns f(params, opt_state, batch) -> (params, opt_state, stats).
    ``batch``: "tokens" (B * G, S), "logp", "ref_logp", "mask" (B * G,
    S - gen_start), "rewards" (B * G,).  One AdamW update on
    :func:`grpo_grads`, in place.  Stats: loss, clip_frac, ratio_mean,
    grad_norm, lr."""
    return _one_update(lambda p, b: grpo_grads(p, cfg, hp, b, gen_start, impl=impl), opt)
