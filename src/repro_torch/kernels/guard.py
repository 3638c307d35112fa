"""How the kernel wrappers meet autograd.

A wrapper fills a ``torch.empty`` tensor through a ``ctypes`` call, so its
output has no ``grad_fn``: differentiated through, autograd would treat the
kernel's result as a constant and return wrong gradients without an error.
The kernels that a train forward runs (``flash_mha``, ``flash_mha_varlen``,
``grouped_ffn``, ``ssd_scan``, ``rglru_scan``) are therefore
``autograd.Function``s with a plain backward, most of them
:func:`plain_grads`.  The two that run only in generation and serving
(``flash_decode``, ``paged_flash_decode``) have no backward and call
:func:`refuse_grad` before they launch.
"""

from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors):
    """Raise ``NotImplementedError`` when autograd would record a launch of
    kernel ``name``: grad mode is on and an input requires grad."""
    # lint: allow(host-sync) -- grad mode and requires_grad are host flags, no device value
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward (no autograd.Function), so its "
            "output would carry no gradient; call it under torch.no_grad(), or "
            "differentiate through impl='reference'")


def plain_grads(fn, tensors, needs, grad_outs):
    """The backward of a kernel through its plain version: recompute
    ``fn(*tensors)`` under autograd and return the gradient, given the
    cotangents ``grad_outs`` of its outputs, of each tensor whose ``needs``
    entry is true (None for the others and for None inputs)."""
    with torch.enable_grad():
        xs = [t if t is None else t.detach().requires_grad_(need)
              for t, need in zip(tensors, needs)]
        out = fn(*xs)
        wrt = [x for x in xs if x is not None and x.requires_grad]
        grads = iter(torch.autograd.grad(out if isinstance(out, tuple) else (out,), wrt,
                                         grad_outs))
    return [next(grads) if x is not None and x.requires_grad else None for x in xs]
