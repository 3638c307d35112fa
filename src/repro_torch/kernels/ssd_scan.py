"""Mamba-2 SSD chunked scan: the hand-written CUDA kernel
``csrc/ssd_scan.cu`` and its plain version.

Counterpart of the JAX package's Pallas kernel ``kernels/ssd_scan.py``
``ssd_pallas``.  Like that kernel it starts from a zero state: an
``init_state`` raises (the reference tier takes one).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.guard import refuse_grad
from repro_torch.kernels.ref import ssd_ref

# Built for mamba2-1.3b's widths only; other widths come with the
# configuration that needs them.
HEAD_DIMS = (64,)      # P
STATE_DIMS = (128,)    # N
DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _entry():
    """The kernel's C entry point, typed once when its library loads."""
    fn = build.library("ssd_scan").repro_ssd_scan
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssd_scan(x, dt, a_log, b_mat, c_mat, d_vec, *, chunk: int, init_state=None,
             return_state: bool = False):
    """Shapes as in ``ref.ssd_ref``: x (B, S, H, P); dt (B, S, H) fp32;
    a_log, d_vec (H,) fp32; b_mat, c_mat (B, S, N) in x's dtype; S a
    multiple of ``chunk``.  Returns y (B, S, H, P) in x's dtype and, with
    ``return_state``, the final state (B, H, P, N) fp32.

    CPU tensors take the plain version ``ssd_ref``; CUDA tensors launch the
    kernel or raise.  The kernel walks the sequence in 64-row pieces of its
    own whatever ``chunk`` is (the chunked form is exact for any chunk
    length); ``chunk`` is checked as the TPU kernel checks it."""
    if x.device.type == "cpu":
        return ssd_ref(x, dt, a_log, b_mat, c_mat, d_vec, chunk=chunk,
                       init_state=init_state, return_state=return_state)
    refuse_grad("ssd_scan", x, dt, a_log, b_mat, c_mat, d_vec)
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
    y = torch.empty_like(x)
    state = (torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
             if return_state else None)
    with torch.cuda.device(dev):
        err = _entry()(
            x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b_mat.data_ptr(),
            c_mat.data_ptr(), d_vec.data_ptr(), y.data_ptr(),
            state.data_ptr() if state is not None else None, b, s, h, p, n,
            int(x.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"ssd_scan: kernel launch failed with CUDA error {err}")
    ssd_scan.launches += 1
    return (y, state) if return_state else y


ssd_scan.launches = 0
