"""Gradient utilities, the port of the JAX package's ``optim/grad.py``:
gradient accumulation over microbatches (the train steps) and the int8
error-feedback all-reduce for slow data-parallel axes, over the port's
collectives on a mesh of logical devices."""

from __future__ import annotations

import torch

from repro_torch.optim import adamw
from repro_torch.parallel import collectives as C


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


# ------------------------------------------------------------- compression

def quantize_int8(g):
    """Per-tensor symmetric int8 quantization.  Returns (q, scale)."""
    scale = (torch.amax(torch.abs(g)) + 1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def compressed_psum(g: dict, mesh, axis: str, error: dict | None = None):
    """int8 error-feedback all-reduce over ``axis`` of ``mesh``: g is {rank:
    gradient}, ``error`` {rank: the residual of the last call} or None.

    The JAX package's two-phase scheme with int8 payloads end to end:
      1. reduce-scatter phase: each rank cuts its gradient (plus its
         residual) into one chunk per peer, quantizes each chunk with its
         own scale, and ``all_to_all`` hands peer i every rank's i-th chunk
         and scale; peer i dequantizes with the true per-(rank, chunk)
         scales and sums them in rank order;
      2. all-gather phase: the reduced chunk is quantized again and
         ``all_gather``ed.
    The residual of phase 1's quantization stays with its rank and is added
    back next call, which keeps the compression unbiased over time.
    Returns ({rank: the mean gradient}, {rank: the new residual}), in g's
    dtype and shape."""
    k = C.axis_size(mesh, axis)
    ranks = list(g)
    shape, dtype = g[ranks[0]].shape, g[ranks[0]].dtype
    flat, q, scales = {}, {}, {}
    for r in ranks:
        x = g[r].to(torch.float32).reshape(-1)
        if error is not None:
            x = x + error[r].to(torch.float32).reshape(-1)
        flat[r] = torch.nn.functional.pad(x, (0, (-x.numel()) % k))
        chunks = flat[r].reshape(k, -1)
        scales[r] = (torch.amax(torch.abs(chunks), dim=1, keepdim=True) + 1e-12) / 127.0
        q[r] = torch.clamp(torch.round(chunks / scales[r]), -127, 127).to(torch.int8)
    new_error = {r: flat[r] - (q[r].to(torch.float32) * scales[r]).reshape(-1) for r in ranks}
    # row j of the result is rank j's copy of this rank's chunk
    q_recv = C.all_to_all(q, mesh, axis)
    s_recv = C.all_to_all(scales, mesh, axis)
    q2, s2 = {}, {}
    for r in ranks:
        terms = q_recv[r].to(torch.float32) * s_recv[r]
        partial = terms[0]
        for j in range(1, k):
            partial = partial + terms[j]
        s2[r] = ((torch.amax(torch.abs(partial)) + 1e-12) / 127.0).reshape(1)
        q2[r] = torch.clamp(torch.round(partial / s2[r]), -127, 127).to(torch.int8)
    qs = C.all_gather({r: x[None] for r, x in q2.items()}, mesh, axis)
    ss = C.all_gather(s2, mesh, axis)
    n = g[ranks[0]].numel()
    mean = {r: ((qs[r].to(torch.float32) * ss[r][:, None]).reshape(-1)[:n] / k)
            .reshape(shape).to(dtype) for r in ranks}
    return mean, {r: e[:n].reshape(shape).to(dtype) for r, e in new_error.items()}
