"""RG-LRU linear recurrence: the hand-written CUDA kernel
``csrc/rglru_scan.cu``, its plain version and its gradient.

Counterpart of the JAX package's Pallas kernel ``kernels/rglru_scan.py``
``rglru_pallas``.  Like that kernel it starts from a zero carry: an
``init_state`` raises on the card (the reference tier takes one).

recurrentgemma's padded train forward differentiates through it, so the
public function is a ``torch.autograd.Function``: its forward is the kernel
(the plain version on CPU tensors), its backward the recurrence run in
reverse (``ref.rglru_scan_bwd_ref``).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import rglru_scan_bwd_ref, rglru_scan_ref

DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _entry():
    """The kernel's C entry point, typed once when its library loads."""
    fn = build.library("rglru_scan").repro_rglru_scan
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(a, bx, init_state):
    """Check the inputs and launch the kernel; raises on what it does not
    take or on a failed launch."""
    if init_state is not None:
        raise ValueError("rglru_scan: the kernel starts from a zero carry; pass "
                         "init_state to the reference tier")
    if not (a.is_cuda and bx.device == a.device):
        raise ValueError("rglru_scan: a and bx must lie on one CUDA device")
    if a.dtype not in DTYPES or bx.dtype != a.dtype:
        raise TypeError(f"rglru_scan: dtypes {a.dtype}/{bx.dtype}; need one of float32, "
                        "bfloat16 for both")
    if a.dim() != 3 or a.shape != bx.shape or min(a.shape) < 1 or a.shape[0] > 65535:
        raise ValueError(f"rglru_scan: unsupported shapes a {tuple(a.shape)}, bx "
                         f"{tuple(bx.shape)}; need one (B, S, W)")
    if not (a.is_contiguous() and bx.is_contiguous()):
        raise ValueError("rglru_scan: a and bx must be contiguous")
    b, s, w = a.shape
    h = torch.empty_like(bx)
    final = torch.empty((b, w), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = _entry()(a.data_ptr(), bx.data_ptr(), h.data_ptr(), final.data_ptr(), b, s, w,
                       int(a.dtype == torch.bfloat16),
                       torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"rglru_scan: kernel launch failed with CUDA error {err}")
    rglru_scan.launches += 1
    return h, final


class _RGLRUScan(torch.autograd.Function):
    """Forward: the kernel on CUDA tensors, the plain version on CPU
    tensors.  Backward: ``rglru_scan_bwd_ref`` on the saved inputs."""

    @staticmethod
    def forward(ctx, a, bx, init_state):
        ctx.save_for_backward(a, bx, init_state)
        if a.device.type == "cpu":
            return rglru_scan_ref(a, bx, init_state)
        return _launch(a, bx, init_state)

    @staticmethod
    def backward(ctx, grad_h, grad_final):
        return rglru_scan_bwd_ref(*ctx.saved_tensors, grad_h, grad_final)


def rglru_scan(a, bx, init_state=None):
    """a, bx: (B, S, W), one dtype.  Returns (h (B, S, W) in bx's dtype,
    the final state (B, W) fp32).

    CPU tensors take the plain version ``rglru_scan_ref``; CUDA tensors
    launch the kernel or raise.  Differentiable in a, bx and (on the CPU)
    ``init_state``."""
    return _RGLRUScan.apply(a, bx, init_state)


rglru_scan.launches = 0
