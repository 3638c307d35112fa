"""The guard of the kernel wrappers that have no backward.

A wrapper fills a ``torch.empty`` tensor through a ``ctypes`` call, so its
output has no ``grad_fn``: differentiated through, autograd would treat the
kernel's result as a constant and return wrong gradients without an error.
Each such wrapper calls :func:`refuse_grad` before it launches.
"""

from __future__ import annotations

import torch


def refuse_grad(name: str, *tensors):
    """Raise ``NotImplementedError`` when autograd would record a launch of
    kernel ``name``: grad mode is on and an input requires grad."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{name}: the CUDA kernel has no backward (no autograd.Function), so its "
            "output would carry no gradient; call it under torch.no_grad(), or "
            "differentiate through impl='reference'")
