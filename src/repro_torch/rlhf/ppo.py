"""PPO for RLHF, as the JAX package's ``rlhf/ppo.py``: per-token KL-shaped
rewards, GAE, the clipped surrogate and clipped value losses, and the
paper's minibatched PPO update (one AdamW update per minibatch, not
gradient accumulation).

Padded shapes: B sequences, G generated tokens each; every padded tensor
is aligned to the generated region.  The packed (``cu_seqlens``) half
works on one (T,) token axis (see "packed path" below).  Both have train
steps: the padded ones (the JAX package's default) differentiate through
``flash_mha`` and, for the recurrent and MoE models, ``ssd_scan``,
``rglru_scan`` and ``grouped_ffn``; the packed ones through
``flash_mha_varlen`` and ``grouped_ffn``.  The MoE load-balance loss is
not part of a PPO loss (the JAX package's ``sequence_logprobs`` drops it
too), so the train forwards do not compute it.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.data import packing
from repro_torch.models import model as MDL
from repro_torch.optim import adamw


@dataclasses.dataclass(frozen=True)
class PPOHyperparameters:
    gamma: float = 1.0
    lam: float = 0.95
    clip_eps: float = 0.2
    value_clip: float = 0.2
    kl_coef: float = 0.1
    entropy_coef: float = 0.0
    n_minibatches: int = 8
    value_coef: float = 0.5


def shaped_rewards(hp: PPOHyperparameters, final_reward, logp, ref_logp, mask):
    """Token rewards: -kl_coef * (logp - ref_logp) with the sequence reward
    on the last valid token.  final_reward: (B,), the rest (B, G)."""
    kl = (logp - ref_logp) * mask
    r = -hp.kl_coef * kl
    last = (mask.cumsum(-1) == mask.sum(-1, keepdim=True)) & (mask > 0)
    return r + final_reward[:, None] * last.to(r.dtype)


def _reverse_gae(hp: PPOHyperparameters, rewards, v_pred, v_next, mask):
    """The GAE recurrence over the last axis, from the end, carry 0 there.
    All (B, L).  Returns the raw advantages (B, L)."""
    carry = torch.zeros_like(rewards[:, 0])
    out = torch.empty_like(rewards)
    for j in range(rewards.shape[1] - 1, -1, -1):
        m = mask[:, j]
        delta = rewards[:, j] + hp.gamma * v_next[:, j] * m - v_pred[:, j]
        carry = delta + hp.gamma * hp.lam * m * carry
        out[:, j] = carry
    return out


def _whiten(adv, mask):
    """Advantage whitening over the valid tokens."""
    n = torch.clamp(mask.sum(), min=1.0)
    mean = (adv * mask).sum() / n
    var = (torch.square(adv - mean) * mask).sum() / n
    return (adv - mean) * torch.rsqrt(var + 1e-8) * mask


def gae(hp: PPOHyperparameters, rewards, values, mask):
    """values: (B, G+1) with the bootstrap column last.  Returns (adv, ret),
    each (B, G); adv whitened over the valid tokens."""
    adv = _reverse_gae(hp, rewards, values[:, :-1], values[:, 1:], mask) * mask
    ret = adv + values[:, :-1] * mask
    return _whiten(adv, mask), ret


def actor_loss_fn(hp: PPOHyperparameters, new_logp, old_logp, adv, mask):
    ratio = torch.exp(torch.clamp(new_logp - old_logp, -20.0, 20.0))
    unclipped = ratio * adv
    clipped = torch.clamp(ratio, 1 - hp.clip_eps, 1 + hp.clip_eps) * adv
    per_tok = -torch.minimum(unclipped, clipped) * mask
    n = torch.clamp(mask.sum(), min=1.0)
    frac_clipped = ((unclipped > clipped) * mask).sum() / n
    return per_tok.sum() / n, {"clip_frac": frac_clipped,
                               "ratio_mean": (ratio * mask).sum() / n}


def critic_loss_fn(hp: PPOHyperparameters, new_values, old_values, returns, mask):
    clipped = old_values + torch.clamp(new_values - old_values, -hp.value_clip,
                                       hp.value_clip)
    l1 = torch.square(new_values - returns)
    l2 = torch.square(clipped - returns)
    n = torch.clamp(mask.sum(), min=1.0)
    return 0.5 * (torch.maximum(l1, l2) * mask).sum() / n


# ------------------------------------------------------------- model glue

def _target_logprobs(logits, targets):
    """log_softmax(logits)[targets] along the last axis, in fp32."""
    logits = logits.to(torch.float32)
    picked = logits.gather(-1, targets[..., None].long())[..., 0]
    return picked - torch.logsumexp(logits, dim=-1)


def sequence_logprobs(params, cfg, tokens, gen_start: int, *, impl="cuda", remat=True):
    """Log-probs of tokens[t] under the model for the generated region.
    tokens: (B, S).  Returns (B, S - gen_start).  ``remat`` recomputes each
    layer in the backward: True for training, False for inference (as the
    JAX package's executors pass it)."""
    h = MDL.forward(params, cfg, {"tokens": tokens}, impl=impl, remat=remat)
    logits = MDL.logits_of(params, cfg, h[:, gen_start - 1:-1])
    return _target_logprobs(logits, tokens[:, gen_start:])


def sequence_values(params, cfg, tokens, gen_start: int, *, impl="cuda", remat=True):
    """Critic values for positions gen_start-1 .. S-1: (B, G+1) with the
    bootstrap column.  ``remat`` as :func:`sequence_logprobs`."""
    h = MDL.forward(params, cfg, {"tokens": tokens}, impl=impl, remat=remat)
    return MDL.values_of(params, h)[:, gen_start - 1:]


# ---------------------------------------------------------- train steps
#
# A train step runs the minibatches of one rollout in order, one AdamW
# update each (the JAX package's ``lax.scan``); its stats are means over
# the minibatches.  A grads function gives the loss, stats and gradients
# (one per ``adamw.leaves(params)``, in that order) of one minibatch.

def _loss_grads(params, loss_fn):
    """(loss, stats, grads) of ``loss_fn(params) -> (loss, stats)`` with
    respect to ``adamw.leaves(params)``, detached."""
    wrt = adamw.leaves(params)
    with torch.enable_grad():
        for p in wrt:
            p.requires_grad_(True)
        loss, stats = loss_fn(params)
        grads = torch.autograd.grad(loss, wrt)
    return loss.detach(), {k: v.detach() for k, v in stats.items()}, list(grads)


def _one_update(grads_fn, opt):
    """f(params, opt_state, batch) -> (params, opt_state, stats): one AdamW
    update on ``grads_fn(params, batch)`` (as :func:`_loss_grads` returns),
    parameters and optimizer state in place; stats: the loss, the grads
    function's and the update's."""
    def step(params, opt_state, batch):
        loss, st, grads = grads_fn(params, batch)
        params, opt_state, ostats = adamw.update(opt, params, opt_state, grads)
        return params, opt_state, {"loss": loss, **st, **ostats}
    return step


def _minibatch_loop(grads_fn, opt):
    """f(params, opt_state, minibatches) -> (params, opt_state, stats) over
    (nmb, ...)-stacked minibatches, one :func:`_one_update` each; stats are
    means over them."""
    update = _one_update(grads_fn, opt)

    def step(params, opt_state, batch):
        stats = []
        for j in range(batch["tokens"].shape[0]):
            params, opt_state, st = update(params, opt_state, {k: v[j] for k, v in batch.items()})
            stats.append(st)
        return params, opt_state, {k: torch.stack([s[k].float() for s in stats]).mean()
                                   for k in stats[0]}
    return step


def split_minibatches(batch, n_minibatches: int):
    """A padded train batch ((B, ...) tensors) as (n_minibatches, B /
    n_minibatches, ...), the JAX package's reshape: minibatch j holds rows
    j * B / n_minibatches onward."""
    b = batch["tokens"].shape[0]
    if b % n_minibatches:
        raise ValueError(f"batch of {b} rows does not split into {n_minibatches} "
                         "minibatches")
    return {k: v.reshape(n_minibatches, b // n_minibatches, *v.shape[1:])
            for k, v in batch.items()}


def actor_grads(params, cfg, hp: PPOHyperparameters, mb, gen_start: int, *, impl="cuda"):
    """Loss, stats and gradients of the padded actor loss on one minibatch
    ``mb``: "tokens" (b, S), "logp", "adv", "mask" (b, S - gen_start).  The
    forward recomputes each layer in the backward (remat)."""
    def loss_fn(p):
        new_logp = sequence_logprobs(p, cfg, mb["tokens"], gen_start, impl=impl)
        return actor_loss_fn(hp, new_logp, mb["logp"], mb["adv"], mb["mask"])
    return _loss_grads(params, loss_fn)


def critic_grads(params, cfg, hp: PPOHyperparameters, mb, gen_start: int, *, impl="cuda"):
    """As :func:`actor_grads` for the padded critic loss; ``mb`` holds
    "values" (the old predictions, (b, G)) and "ret" in place of "logp"
    and "adv".  Stats are empty."""
    def loss_fn(p):
        v = sequence_values(p, cfg, mb["tokens"], gen_start, impl=impl)
        return critic_loss_fn(hp, v[:, :-1], mb["values"], mb["ret"], mb["mask"]), {}
    return _loss_grads(params, loss_fn)


def _make_padded_step(grads_fn, cfg, hp, opt, gen_start, impl):
    loop = _minibatch_loop(lambda p, mb: grads_fn(p, cfg, hp, mb, gen_start, impl=impl), opt)

    def step(params, opt_state, batch):
        return loop(params, opt_state, split_minibatches(batch, hp.n_minibatches))
    return step


def make_actor_train_step(cfg, hp: PPOHyperparameters, opt: adamw.AdamWConfig,
                          gen_start: int, *, impl="cuda"):
    """Returns f(params, opt_state, batch) -> (params, opt_state, stats), the
    JAX package's ``make_actor_train_step``.  ``batch``: "tokens" (B, S),
    "logp", "adv", "mask" (B, S - gen_start), split by
    :func:`split_minibatches` into ``hp.n_minibatches`` minibatches; stats
    (loss, clip_frac, ratio_mean, grad_norm, lr) are means over them."""
    return _make_padded_step(actor_grads, cfg, hp, opt, gen_start, impl)


def make_critic_train_step(cfg, hp: PPOHyperparameters, opt: adamw.AdamWConfig,
                           gen_start: int, *, impl="cuda"):
    """The padded critic step; ``batch`` as the actor's with "values" (B,
    S - gen_start) and "ret" in place of "logp" and "adv".  Stats: loss,
    grad_norm, lr."""
    return _make_padded_step(critic_grads, cfg, hp, opt, gen_start, impl)


# -------------------------------------------------- packed (cu_seqlens) path
#
# The packed layout flattens the cohort to one (T,) token axis with
# ``cu_seqlens`` segment offsets (data/packing.py).  Every per-token array
# is aligned to the target token: new_logp[j] =
# log_softmax(logits[j-1])[tokens[j]], v_pred[j] = values[j-1], v_next[j] =
# values[j].  With right-padded inputs and one post-EOS bootstrap token
# kept per sequence, the packed losses and advantages equal the padded ones
# on valid tokens; phantom tokens past cu_seqlens[-1] carry mask 0.

def packed_last_valid(mask, cu_seqlens):
    """1 at each sequence's last mask > 0 token, else 0 (the packed
    counterpart of ``shaped_rewards``' ``last``).  mask: (T,)."""
    t = mask.shape[0]
    cu = cu_seqlens.to(torch.int64)
    b = cu.shape[0] - 1
    seg = packing.segment_ids_of(cu, t).long()  # phantoms get id B
    segc = torch.clamp(seg, max=b - 1)
    cm = torch.cumsum(mask, 0)
    excl = cm - mask
    start = excl[cu[:-1]]  # (B,) the mask sum before each sequence
    total_m = cm[cu[1:] - 1] - start  # (B,) the mask sum within it
    within = cm - start[segc]
    return ((within == total_m[segc]) & (mask > 0) & (seg < b)).to(mask.dtype)


def shaped_rewards_packed(hp: PPOHyperparameters, final_reward, logp, ref_logp, mask,
                          cu_seqlens):
    """Packed :func:`shaped_rewards`: final_reward (B,), the rest (T,)."""
    kl = (logp - ref_logp) * mask
    r = -hp.kl_coef * kl
    b = cu_seqlens.shape[0] - 1
    seg = torch.clamp(packing.segment_ids_of(cu_seqlens, mask.shape[0]).long(), max=b - 1)
    return r + final_reward[seg] * packed_last_valid(mask, cu_seqlens)


def gae_packed(hp: PPOHyperparameters, rewards, v_pred, v_next, mask, cu_seqlens):
    """Packed :func:`gae`: the recurrence with the carry reset at every
    sequence end (``cu_seqlens[1:] - 1``), so it never crosses a segment
    boundary.  All args (T,); returns (adv, ret), both (T,), 0 on
    phantoms.

    The JAX package scans the T tokens one by one; here the sequences are
    unpacked side by side (zeros past each end) and one reverse scan over
    the longest length steps them all: the zero padding brings a carry of
    0 into every sequence's last token, which is the reset."""
    cu = cu_seqlens.detach().cpu().numpy()
    lens = cu[1:] - cu[:-1]
    longest = int(lens.max())
    real = int(cu[-1])
    cols = [packing.unpack(x[:real], lens, longest) for x in (rewards, v_pred, v_next, mask)]
    adv = packing.pack(_reverse_gae(hp, *cols), lens)
    adv = torch.nn.functional.pad(adv, (0, rewards.shape[0] - real)) * mask
    ret = adv + v_pred * mask
    return _whiten(adv, mask), ret


def packed_sequence_logprobs(params, cfg, batch, *, impl="cuda", remat=True,
                             max_seqlen=None):
    """Target-aligned log-probs over a packed cohort: out[j] =
    log_softmax(logits[j-1])[tokens[j]], out[0] = 0 (the first packed token
    is a prompt token, mask 0).  Returns (T,)."""
    h = MDL.forward(params, cfg, batch, impl=impl, remat=remat, max_seqlen=max_seqlen)
    logits = MDL.logits_of(params, cfg, h[:, :-1])[0]  # (T-1, V)
    out = _target_logprobs(logits, batch["tokens"][1:])
    return torch.cat([torch.zeros((1,), dtype=out.dtype, device=out.device), out])


def packed_sequence_values(params, cfg, batch, *, impl="cuda", remat=True,
                           max_seqlen=None):
    """Critic values per packed position: (T,).  The target-aligned
    prediction for token j is values[j-1] (:func:`packed_shift_right`)."""
    h = MDL.forward(params, cfg, batch, impl=impl, remat=remat, max_seqlen=max_seqlen)
    return MDL.values_of(params, h)[0]


def packed_shift_right(x):
    """v_pred alignment: out[j] = x[j-1], out[0] = 0."""
    return torch.cat([torch.zeros((1,), dtype=x.dtype, device=x.device), x[:-1]])


def _cohort(mb):
    return {"tokens": mb["tokens"], "cu_seqlens": mb["cu_seqlens"],
            "positions": mb["positions"]}


def packed_actor_grads(params, cfg, hp: PPOHyperparameters, mb, *, impl="cuda",
                       max_seqlen=None, remat=True):
    """Loss, stats and gradients (one per ``adamw.leaves(params)``, in that
    order) of the packed actor loss on one minibatch ``mb`` (one row of
    ``pack_minibatches``' output: "tokens", "positions", "cu_seqlens",
    "logp", "adv", "mask")."""
    def loss_fn(p):
        new_logp = packed_sequence_logprobs(p, cfg, _cohort(mb), impl=impl, remat=remat,
                                            max_seqlen=max_seqlen)
        return actor_loss_fn(hp, new_logp, mb["logp"], mb["adv"], mb["mask"])
    return _loss_grads(params, loss_fn)


def packed_critic_grads(params, cfg, hp: PPOHyperparameters, mb, *, impl="cuda",
                        max_seqlen=None, remat=True):
    """As :func:`packed_actor_grads` for the packed critic loss; ``mb``
    holds "values" (old target-aligned predictions) and "ret" in place of
    "logp" and "adv".  Stats are empty."""
    def loss_fn(p):
        v = packed_sequence_values(p, cfg, _cohort(mb), impl=impl, remat=remat,
                                   max_seqlen=max_seqlen)
        return critic_loss_fn(hp, packed_shift_right(v), mb["values"], mb["ret"],
                              mb["mask"]), {}
    return _loss_grads(params, loss_fn)


def _make_packed_step(grads_fn, cfg, hp, opt, impl, max_seqlen, remat):
    return _minibatch_loop(lambda p, mb: grads_fn(p, cfg, hp, mb, impl=impl,
                                                  max_seqlen=max_seqlen, remat=remat), opt)


def make_packed_actor_train_step(cfg, hp: PPOHyperparameters, opt: adamw.AdamWConfig, *,
                                 impl="cuda", max_seqlen=None, remat=True):
    """Returns f(params, opt_state, batch) -> (params, opt_state, stats).
    ``batch`` holds (nmb, Tmb)-stacked tensors from
    ``packing.pack_minibatches``: "tokens", "positions", "logp", "adv",
    "mask", and (nmb, B/nmb + 1) "cu_seqlens".  One AdamW update per
    minibatch, in order (the JAX package's ``lax.scan``); stats (loss,
    clip_frac, ratio_mean, grad_norm, lr) are means over the minibatches.
    Parameters and optimizer state are updated in place."""
    return _make_packed_step(packed_actor_grads, cfg, hp, opt, impl, max_seqlen, remat)


def make_packed_critic_train_step(cfg, hp: PPOHyperparameters, opt: adamw.AdamWConfig, *,
                                  impl="cuda", max_seqlen=None, remat=True):
    """The packed critic step; ``batch`` as the actor's with "values" and
    "ret" in place of "logp" and "adv".  Stats: loss, grad_norm, lr."""
    return _make_packed_step(packed_critic_grads, cfg, hp, opt, impl, max_seqlen, remat)
