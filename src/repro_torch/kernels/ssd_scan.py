"""Mamba-2 SSD chunked scan: the hand-written CUDA kernel
``csrc/ssd_scan.cu``, its plain version and its gradient.

Counterpart of the JAX package's Pallas kernel ``kernels/ssd_scan.py``
``ssd_pallas``.  Like that kernel it starts from a zero state: an
``init_state`` raises on the card (the reference tier takes one).  bf16
inputs run a tensor-core body over 128-row pieces on a (p_splits, H, B)
grid (``ssd_splits``); fp32 inputs an fp32-FMA body, one block per (head,
row).

mamba2's padded train forward differentiates through it, so the public
function is a ``torch.autograd.Function`` with outputs y and the final
state: its forward is the kernel (the plain version on CPU tensors), its
backward autograd of the plain version ``ssd_ref`` at the caller's
``chunk``, recomputed over both outputs (the JAX package differentiates
its reference tier; its Pallas kernel has no backward).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.guard import plain_grads
from repro_torch.kernels.ref import ssd_ref

# Built for mamba2-1.3b's widths only; other widths come with the
# configuration that needs them.
HEAD_DIMS = (64,)      # P
STATE_DIMS = (128,)    # N
DTYPES = (torch.float32, torch.bfloat16)
P_SPLITS = (1, 2, 4)  # blocks per (row, head) the bf16 body may take, each P / p_splits wide


@functools.cache
def _entry():
    """The kernel's C entry point, typed once when its library loads."""
    fn = build.library("ssd_scan").repro_ssd_scan
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssd_splits(b: int, h: int, sms: int) -> int:
    """Blocks per (row, head) of the bf16 body, from shapes alone: the p in
    P_SPLITS that minimises waves x work per block on ``sms`` SMs (one
    block per SM), where a block's work is C.B^T, which every split
    recomputes, plus three products split p ways, each about as large as
    C.B^T.  A 1-row admission of mamba2-1.3b's 64 heads takes 2 (128
    blocks), 2 rows or more 1."""
    def cost(p):
        return -(-b * h * p // sms) * (1 + 3 / p)
    return min(P_SPLITS, key=cost)


def _launch(x, dt, a_log, b_mat, c_mat, d_vec, chunk, init_state, return_state,
            p_splits):
    """Check the inputs and launch the kernel; raises on what it does not
    take or on a failed launch."""
    if init_state is not None:
        raise ValueError("ssd_scan: the kernel starts from a zero state; pass "
                         "init_state to the reference tier")
    dev = x.device
    tensors = (x, dt, a_log, b_mat, c_mat, d_vec)
    if not (x.is_cuda and all(t.device == dev for t in tensors)):
        raise ValueError("ssd_scan: inputs must lie on one CUDA device")
    if (x.dtype not in DTYPES or b_mat.dtype != x.dtype or c_mat.dtype != x.dtype
            or any(t.dtype != torch.float32 for t in (dt, a_log, d_vec))):
        raise TypeError(f"ssd_scan: dtypes x {x.dtype}, b {b_mat.dtype}, c {c_mat.dtype}, "
                        f"dt {dt.dtype}, a_log {a_log.dtype}, d {d_vec.dtype}; need x, b, c "
                        "float32 or bfloat16 alike, dt, a_log, d float32")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (B, S, H, P); got {tuple(x.shape)}")
    b, s, h, p = x.shape
    n = b_mat.shape[-1]
    if (tuple(dt.shape) != (b, s, h) or tuple(b_mat.shape) != (b, s, n)
            or tuple(c_mat.shape) != (b, s, n) or tuple(a_log.shape) != (h,)
            or tuple(d_vec.shape) != (h,) or p not in HEAD_DIMS or n not in STATE_DIMS
            or chunk < 1 or s % chunk or b > 65535):
        raise ValueError(f"ssd_scan: unsupported shapes x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, b {tuple(b_mat.shape)}, c "
                         f"{tuple(c_mat.shape)}, a_log {tuple(a_log.shape)}, d "
                         f"{tuple(d_vec.shape)}, chunk {chunk} (P in {HEAD_DIMS}, N in "
                         f"{STATE_DIMS}, S a multiple of chunk)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan: inputs must be contiguous")
    bf16 = x.dtype == torch.bfloat16
    if p_splits is None:
        p_splits = ssd_splits(b, h, build.sm_count(dev.index)) if bf16 else 1
    if p_splits not in (P_SPLITS if bf16 else (1,)):
        raise ValueError(f"ssd_scan: p_splits {p_splits} (bf16 takes {P_SPLITS}, fp32 1)")
    y = torch.empty_like(x)
    state = (torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
             if return_state else None)
    with torch.cuda.device(dev):
        err = _entry()(
            x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b_mat.data_ptr(),
            c_mat.data_ptr(), d_vec.data_ptr(), y.data_ptr(),
            state.data_ptr() if state is not None else None, b, s, h, p, n, int(bf16),
            p_splits, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan: kernel launch failed with CUDA error {err}")
    ssd_scan.launches += 1
    return (y, state) if return_state else y


class _SSDScan(torch.autograd.Function):
    """Forward: the kernel on CUDA tensors, the plain version on CPU
    tensors.  Backward: autograd of the plain version on the saved inputs
    at the forward's ``chunk``, over y and (with ``return_state``) the
    final state."""

    @staticmethod
    def forward(ctx, x, dt, a_log, b_mat, c_mat, d_vec, init_state, chunk, return_state,
                p_splits):
        ctx.save_for_backward(x, dt, a_log, b_mat, c_mat, d_vec, init_state)
        ctx.chunk, ctx.return_state = chunk, return_state
        if x.device.type == "cpu":
            return ssd_ref(x, dt, a_log, b_mat, c_mat, d_vec, chunk=chunk,
                           init_state=init_state, return_state=return_state)
        return _launch(x, dt, a_log, b_mat, c_mat, d_vec, chunk, init_state, return_state,
                       p_splits)

    @staticmethod
    def backward(ctx, *grad_outs):
        def plain(*t):
            return ssd_ref(*t[:6], chunk=ctx.chunk, init_state=t[6],
                           return_state=ctx.return_state)
        return (*plain_grads(plain, ctx.saved_tensors, ctx.needs_input_grad, grad_outs),
                None, None, None)


def ssd_scan(x, dt, a_log, b_mat, c_mat, d_vec, *, chunk: int, init_state=None,
             return_state: bool = False, p_splits: int | None = None):
    """Shapes as in ``ref.ssd_ref``: x (B, S, H, P); dt (B, S, H) fp32;
    a_log, d_vec (H,) fp32; b_mat, c_mat (B, S, N) in x's dtype; S a
    multiple of ``chunk``.  Returns y (B, S, H, P) in x's dtype and, with
    ``return_state``, the final state (B, H, P, N) fp32.

    CPU tensors take the plain version ``ssd_ref``; CUDA tensors launch the
    kernel or raise.  The kernel walks the sequence in pieces of its own
    (128 rows in bf16, 64 in fp32) whatever ``chunk`` is (the chunked form
    is exact for any chunk length); ``chunk`` is checked as the TPU kernel
    checks it.  ``p_splits`` (bf16 only; default ``ssd_splits``) changes
    no bit of the result.  Differentiable in every tensor input."""
    return _SSDScan.apply(x, dt, a_log, b_mat, c_mat, d_vec, init_state, chunk,
                          return_state, p_splits)


ssd_scan.launches = 0


def kernel_info(p_splits: int) -> dict:
    """Registers, spill bytes, shared memory and blocks per SM of the bf16
    body at ``p_splits``."""
    return build.tile_info("ssd_scan", "repro_ssd_scan_bf16_info", p_splits)
