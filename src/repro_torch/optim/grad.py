"""Gradient accumulation over microbatches, the part of the JAX package's
``optim/grad.py`` that the single-device train step calls (its int8
compression for cross-pod data parallelism is not ported)."""

from __future__ import annotations

import torch

from repro_torch.optim import adamw


def _value_and_grad(loss_fn, params, batch):
    wrt = adamw.leaves(params)
    with torch.enable_grad():
        loss, aux = loss_fn(params, batch)
        grads = torch.autograd.grad(loss, wrt)
    return loss.detach(), list(grads), {k: v.detach() for k, v in aux.items()}


def accumulate_grads(loss_fn, params, batch, n_micro: int):
    """Split ``batch`` along axis 0 into ``n_micro`` microbatches and
    accumulate the gradients in fp32 (their mean).  ``loss_fn(params,
    batch) -> (loss, aux)``; the gradients are with respect to
    ``adamw.leaves(params)``, which must require grad.  Returns (mean_loss,
    grads, the last microbatch's aux)."""
    if n_micro <= 1:
        return _value_and_grad(loss_fn, params, batch)
    b = next(iter(batch.values())).shape[0]
    if b % n_micro:
        raise ValueError(f"batch of {b} rows does not split into {n_micro} microbatches")
    acc, loss_sum, aux = None, 0.0, {}
    for j in range(n_micro):
        mb = {k: v.reshape(n_micro, b // n_micro, *v.shape[1:])[j] for k, v in batch.items()}
        loss, grads, aux = _value_and_grad(loss_fn, params, mb)
        grads = [g.to(torch.float32) for g in grads]
        acc = grads if acc is None else [a + g for a, g in zip(acc, grads)]
        loss_sum = loss_sum + loss
    return loss_sum / n_micro, [a / n_micro for a in acc], aux
