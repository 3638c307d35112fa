"""ReMax (paper §8.3), as the JAX package's ``rlhf/remax.py``: REINFORCE
with a greedy rollout's reward as the baseline.  Its two generation calls
are independent, so the dataflow graph lets them run concurrently, which
is why ReMax shows the largest plan-search gain in Fig. 16."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.optim import adamw
from repro_torch.rlhf.ppo import _loss_grads, _one_update, sequence_logprobs


@dataclasses.dataclass(frozen=True)
class ReMaxHyperparameters:
    kl_coef: float = 0.05


def remax_grads(params, cfg, hp: ReMaxHyperparameters, batch, gen_start: int, *,
                impl="cuda"):
    """Loss, empty stats and gradients (one per ``adamw.leaves(params)``)
    of the ReMax loss on ``batch`` (as :func:`make_remax_train_step` takes
    it): the policy gradient on reward minus baseline plus ``kl_coef``
    times logp - ref_logp, both over the valid tokens."""
    adv = (batch["rewards"] - batch["rewards_baseline"])[:, None]

    def loss_fn(p):
        new_logp = sequence_logprobs(p, cfg, batch["tokens"], gen_start, impl=impl)
        kl = (new_logp - batch["ref_logp"]) * batch["mask"]
        pg = -(adv * new_logp * batch["mask"])
        n = torch.clamp(batch["mask"].sum(), min=1.0)
        return (pg.sum() + hp.kl_coef * kl.sum()) / n, {}
    return _loss_grads(params, loss_fn)


def make_remax_train_step(cfg, hp: ReMaxHyperparameters, opt: adamw.AdamWConfig,
                          gen_start: int, *, impl="cuda"):
    """Returns f(params, opt_state, batch) -> (params, opt_state, stats).
    ``batch``: "tokens" (B, S), "mask", "ref_logp" (B, S - gen_start),
    "rewards" and "rewards_baseline" (B,).  One AdamW update on
    :func:`remax_grads`, in place.  Stats: loss, grad_norm, lr."""
    return _one_update(lambda p, b: remax_grads(p, cfg, hp, b, gen_start, impl=impl), opt)
