"""Direct Preference Optimization (paper §8.3), as the JAX package's
``rlhf/dpo.py``: two function calls, reference inference over (chosen,
rejected) pairs, then one policy train step (one AdamW update) on them."""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.optim import adamw
from repro_torch.rlhf.ppo import _loss_grads, _one_update, sequence_logprobs


@dataclasses.dataclass(frozen=True)
class DPOHyperparameters:
    beta: float = 0.1


def dpo_loss(hp: DPOHyperparameters, pol_chosen, pol_rejected, ref_chosen, ref_rejected):
    """Sequence-level summed logprobs, each (B,).  Returns (loss, stats);
    ``dpo_acc`` is the share of pairs the policy already prefers over the
    reference (0 while the two are equal)."""
    logits = hp.beta * ((pol_chosen - ref_chosen) - (pol_rejected - ref_rejected))
    loss = -F.logsigmoid(logits).mean()
    return loss, {"dpo_acc": (logits > 0).to(torch.float32).mean(),
                  "margin": logits.mean()}


def seq_logp_sum(params, cfg, tokens, mask, gen_start: int, *, impl="cuda", remat=True):
    """The summed log-probs of tokens[:, gen_start:] under the mask: (B,)
    fp32.  ``remat`` as ``ppo.sequence_logprobs`` (False for the reference's
    inference)."""
    lp = sequence_logprobs(params, cfg, tokens, gen_start, impl=impl, remat=remat)
    return (lp * mask[:, gen_start:]).sum(-1)


def dpo_grads(params, cfg, hp: DPOHyperparameters, batch, gen_start: int, *, impl="cuda"):
    """Loss, stats and gradients (one per ``adamw.leaves(params)``) of the
    DPO loss on ``batch`` (as :func:`make_dpo_train_step` takes it); the
    policy's forwards recompute each layer in the backward (remat)."""
    def loss_fn(p):
        pc = seq_logp_sum(p, cfg, batch["chosen"], batch["chosen_mask"], gen_start, impl=impl)
        pr = seq_logp_sum(p, cfg, batch["rejected"], batch["rejected_mask"], gen_start,
                          impl=impl)
        return dpo_loss(hp, pc, pr, batch["ref_chosen_logp"], batch["ref_rejected_logp"])
    return _loss_grads(params, loss_fn)


def make_dpo_train_step(cfg, hp: DPOHyperparameters, opt: adamw.AdamWConfig,
                        gen_start: int, *, impl="cuda"):
    """Returns f(params, opt_state, batch) -> (params, opt_state, stats).
    ``batch``: "chosen", "rejected" (B, S) int32, "chosen_mask",
    "rejected_mask" (B, S), "ref_chosen_logp", "ref_rejected_logp" (B,).
    One AdamW update, parameters and state in place; stats: loss, dpo_acc,
    margin, grad_norm, lr."""
    return _one_update(lambda p, b: dpo_grads(p, cfg, hp, b, gen_start, impl=impl), opt)
