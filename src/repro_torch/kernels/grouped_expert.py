"""Grouped gated expert FFN (dropless MoE): the hand-written CUDA kernel
``csrc/grouped_expert.cu``, its plain version and its gradient.

Counterpart of the JAX package's Pallas kernel ``kernels/grouped_expert.py``
``grouped_ffn`` (forward ``_forward``).  bf16 inputs run both products on
``wgmma`` with the intermediate H kept as two bf16 terms; fp32 inputs an
fp32-FMA body.

MoE training differentiates through it, so the public function is a
``torch.autograd.Function``: its forward is the kernel (the plain version
on CPU tensors), its backward ``ref.grouped_ffn_bwd_ref``, the JAX
package's ``custom_vjp`` backward ``_diff_bwd`` computed per expert segment
in fp32.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import grouped_ffn_bwd_ref, grouped_ffn_ref

DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _entry():
    """The kernel's C entry point, typed once when its library loads."""
    fn = build.library("grouped_expert").repro_grouped_ffn
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(xs, group_sizes, w_gate, w_in, w_out, act):
    """Check the inputs and launch the kernel; raises on what it does not
    take or on a failed launch."""
    dev = xs.device
    tensors = (xs, group_sizes, w_gate, w_in, w_out)
    if not (xs.is_cuda and all(t.device == dev for t in tensors)):
        raise ValueError("grouped_ffn: xs, group_sizes and the weights must lie on one "
                         "CUDA device")
    if xs.dtype not in DTYPES or any(w.dtype != xs.dtype for w in (w_gate, w_in, w_out)):
        raise TypeError(f"grouped_ffn: dtypes {xs.dtype}/{w_gate.dtype}/{w_in.dtype}/"
                        f"{w_out.dtype}; need one of float32, bfloat16 for all")
    if group_sizes.dtype != torch.int32:
        raise TypeError(f"grouped_ffn: group_sizes must be int32; got {group_sizes.dtype}")
    if act != "silu":
        raise ValueError(f"grouped_ffn: act={act!r}; the kernel takes 'silu' only")
    if xs.dim() != 2 or w_gate.dim() != 3:
        raise ValueError(f"grouped_ffn: shapes xs {tuple(xs.shape)}, w_gate "
                         f"{tuple(w_gate.shape)}")
    n, d = xs.shape
    e, _, f = w_gate.shape
    if (tuple(w_gate.shape) != (e, d, f) or tuple(w_in.shape) != (e, d, f)
            or tuple(w_out.shape) != (e, f, d) or tuple(group_sizes.shape) != (e,)
            or d % 8 or f % 8 or e < 1):
        raise ValueError(f"grouped_ffn: unsupported shapes xs {tuple(xs.shape)}, "
                         f"group_sizes {tuple(group_sizes.shape)}, w_gate "
                         f"{tuple(w_gate.shape)}, w_in {tuple(w_in.shape)}, w_out "
                         f"{tuple(w_out.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("grouped_ffn: inputs must be contiguous")
    if any(t.data_ptr() % 16 for t in (xs, w_gate, w_in, w_out)):
        raise ValueError("grouped_ffn: xs and the weights must start 16-byte aligned "
                         "(the kernel reads them in 16-byte loads)")
    out = torch.empty((n, d), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    bf16 = xs.dtype == torch.bfloat16
    # H = silu(x.Wg) * (x.Wi): in fp32, or as its bf16 terms H_hi and H_lo
    h = torch.empty((2, n, f) if bf16 else (n, f), dtype=xs.dtype, device=dev)
    with torch.cuda.device(dev):
        err = _entry()(
            xs.data_ptr(), group_sizes.data_ptr(), w_gate.data_ptr(), w_in.data_ptr(),
            w_out.data_ptr(), h.data_ptr(), out.data_ptr(), n, d, f, e, int(bf16),
            torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"grouped_ffn: kernel launch failed with CUDA error {err}")
    grouped_ffn.launches += 1
    return out


class _GroupedFFN(torch.autograd.Function):
    """Forward: the kernel on CUDA tensors, the plain version on CPU
    tensors or with ``plain``.  Backward: ``grouped_ffn_bwd_ref`` on the
    saved inputs (no gradient for ``group_sizes``)."""

    @staticmethod
    def forward(ctx, xs, group_sizes, w_gate, w_in, w_out, act, plain):
        ctx.save_for_backward(xs, group_sizes, w_gate, w_in, w_out)
        ctx.act = act
        if plain or xs.device.type == "cpu":
            return grouped_ffn_ref(xs, group_sizes, w_gate, w_in, w_out, act=act)
        return _launch(xs, group_sizes, w_gate, w_in, w_out, act)

    @staticmethod
    def backward(ctx, grad_out):
        xs, group_sizes, w_gate, w_in, w_out = ctx.saved_tensors
        dx, dwg, dwi, dwo = grouped_ffn_bwd_ref(xs, group_sizes, w_gate, w_in, w_out,
                                                grad_out, act=ctx.act)
        return dx, None, dwg, dwi, dwo, None, None


def grouped_ffn(xs, group_sizes, w_gate, w_in, w_out, *, act="silu"):
    """xs: (N, D) expert-sorted rows; group_sizes: (E,) int32 rows per
    expert, summing to N; w_gate/w_in: (E, D, F); w_out: (E, F, D).
    Returns (N, D) float32: row i through its own expert only, rows past
    sum(group_sizes) zero.

    CPU tensors take the plain version ``grouped_ffn_ref``; CUDA tensors
    launch the kernel or raise.  The kernel takes act="silu" (every MoE
    config of the repo), fp32 or bf16 (the same for xs and the weights)
    and D, F multiples of 8.  Differentiable in xs and the weights."""
    return _GroupedFFN.apply(xs, group_sizes, w_gate, w_in, w_out, act, False)


grouped_ffn.launches = 0


def grouped_ffn_plain(xs, group_sizes, w_gate, w_in, w_out, *, act="silu"):
    """The reference tier: ``grouped_ffn_ref`` on any device, with
    ``grouped_ffn``'s backward.  Autograd through the plain version's
    per-expert loop would save an fp32 copy of every expert weight (54 GB
    for one Arctic layer)."""
    return _GroupedFFN.apply(xs, group_sizes, w_gate, w_in, w_out, act, True)


def kernel_info(launch: int) -> dict:
    """Registers, spill bytes, shared memory and blocks per SM of the bf16
    body's launch A (0: H) or B (1: the output)."""
    return build.tile_info("grouped_expert", "repro_grouped_ffn_bf16_info", launch)
