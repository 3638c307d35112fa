"""Packed variable-length flash attention (``cu_seqlens``; GQA, causal /
sliding-window): the hand-written CUDA kernel ``csrc/varlen_attention.cu``,
its plain version and its gradient.

Counterpart of the JAX package's Pallas kernel
``kernels/varlen_attention.py`` ``flash_mha_varlen``.  The packed train
forward differentiates through it, so the public function is a
``torch.autograd.Function``: its forward is the kernel (the plain version
on CPU tensors) and its backward is the gradient of the plain version
``mha_varlen_ref``, recomputed banded by ``max_seqlen``.  That is the
gradient the JAX package takes on its reference tier (its Pallas kernel
has no backward), and the pattern of its ``grouped_expert.py``
``_diff_bwd``: a hand-written forward, a plain backward.  The backward
holds O(T * max_seqlen * Hq) fp32 scores per layer while it runs.  bf16
inputs run the tensor-core tile body ``csrc/attn_tile.cuh`` (shared with
``flash_attention``), fp32 inputs an fp32-FMA body.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.guard import plain_grads
from repro_torch.kernels.ref import mha_varlen_ref

HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _entry():
    """The kernel's C entry point, typed once when its library loads."""
    fn = build.library("varlen_attention").repro_flash_mha_varlen
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(q, k, v, cu_seqlens, causal: bool, window: int | None):
    """Check the inputs and launch the kernel; raises on what it does not
    take or on a failed launch."""
    dev = q.device
    if not (q.is_cuda and all(t.device == dev for t in (k, v, cu_seqlens))):
        raise ValueError("flash_mha_varlen: q, k, v and cu_seqlens must lie on one "
                         "CUDA device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_mha_varlen: dtypes {q.dtype}/{k.dtype}/{v.dtype}; need "
                        "one of float32, bfloat16 for all three")
    if cu_seqlens.dtype != torch.int32:
        raise TypeError(f"flash_mha_varlen: cu_seqlens must be int32; got "
                        f"{cu_seqlens.dtype}")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or cu_seqlens.dim() != 1:
        raise ValueError(f"flash_mha_varlen: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, cu_seqlens "
                         f"{tuple(cu_seqlens.shape)}")
    t, hq, d = q.shape
    tk, hkv, dk = k.shape
    if (tk != t or dk != d or d not in HEAD_DIMS or hq % hkv or t < 1
            or cu_seqlens.numel() < 2 or hq > 65535):
        raise ValueError(f"flash_mha_varlen: unsupported shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, cu_seqlens {tuple(cu_seqlens.shape)} "
                         f"(head_dim in {HEAD_DIMS}, Hq a multiple of Hkv, B >= 1)")
    if not all(x.is_contiguous() for x in (q, k, v, cu_seqlens)):
        raise ValueError("flash_mha_varlen: inputs must be contiguous")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_mha_varlen: q, k, v must be 16-byte aligned")
    if window is not None and window < 1:
        raise ValueError(f"flash_mha_varlen: window must be >= 1; got {window}")
    out = torch.empty_like(q)
    with torch.cuda.device(dev):
        err = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            cu_seqlens.data_ptr(), t, cu_seqlens.numel() - 1, hq, hkv, d, int(causal),
            window or 0, int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_mha_varlen: kernel launch failed with CUDA error {err}")
    flash_mha_varlen.launches += 1
    return out


class _VarlenAttention(torch.autograd.Function):
    """Forward: the kernel on CUDA tensors, the plain version on CPU
    tensors.  Backward: autograd of the plain version on the saved inputs
    (no gradient for ``cu_seqlens``)."""

    @staticmethod
    def forward(ctx, q, k, v, cu_seqlens, causal, window, max_seqlen):
        ctx.save_for_backward(q, k, v, cu_seqlens)
        ctx.kw = dict(causal=causal, window=window, max_seqlen=max_seqlen)
        if q.device.type == "cpu":
            return mha_varlen_ref(q, k, v, cu_seqlens, **ctx.kw)
        return _launch(q, k, v, cu_seqlens, causal, window)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, cu_seqlens = ctx.saved_tensors

        def plain(q, k, v):
            return mha_varlen_ref(q, k, v, cu_seqlens, **ctx.kw)
        return (*plain_grads(plain, (q, k, v), ctx.needs_input_grad, (grad_out,)),
                None, None, None, None)


def flash_mha_varlen(q, k, v, cu_seqlens, *, causal: bool = True,
                     window: int | None = None, max_seqlen: int | None = None):
    """q: (T, Hq, D); k/v: (T, Hkv, D); cu_seqlens: (B+1,) int32.  Returns
    (T, Hq, D); rows at or beyond cu_seqlens[-1] form their own segment.

    CPU tensors take the plain version ``mha_varlen_ref``; CUDA tensors
    launch the kernel or raise.  The kernel finds its key ranges from
    ``cu_seqlens`` itself and ignores ``max_seqlen``, as the TPU kernel
    does; the backward recomputes the plain version banded by it.
    Differentiable in q, k and v."""
    return _VarlenAttention.apply(q, k, v, cu_seqlens, causal, window, max_seqlen)


flash_mha_varlen.launches = 0


def kernel_info(d: int) -> dict:
    """Registers, spill bytes, shared memory and blocks per SM of the bf16
    kernel at head_dim ``d``."""
    return build.tile_info("varlen_attention", "repro_flash_mha_varlen_bf16_info", d)
