"""Flash attention (GQA, causal / sliding-window, optional positions): the
hand-written CUDA kernel ``csrc/flash_attention.cu``, its plain version and
its gradient.

Counterpart of the JAX package's Pallas kernel ``kernels/flash_attention.py``
``flash_mha``.  Unlike that kernel, explicit ``q_positions``/``kv_positions``
are honoured: with them the kernel masks by position and skips no KV tile;
without them it takes the arange fast path with causal/window tile skipping.
bf16 inputs run the tensor-core tile body ``csrc/attn_tile.cuh`` (shared
with ``varlen_attention``), fp32 inputs an fp32-FMA body.

The padded train forward differentiates through it, so the public function
is a ``torch.autograd.Function`` as ``varlen_attention``'s: its forward is
the kernel (the plain version on CPU tensors), its backward the gradient of
the plain version ``mha_ref`` recomputed with the forward's own ``causal``,
``window`` and positions (the JAX package differentiates its reference
tier; its Pallas kernel has no backward).  The backward holds B x Hq x Sq x
Skv fp32 scores per layer while it runs.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.guard import plain_grads
from repro_torch.kernels.ref import mha_ref

HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)


@functools.cache
def _entry():
    """The kernel's C entry point, typed once when its library loads."""
    fn = build.library("flash_attention").repro_flash_mha
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 9 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _positions(pos, b: int, s: int, device) -> torch.Tensor:
    if pos is None:
        pos = torch.arange(s, device=device)[None, :]
    if pos.dim() != 2 or pos.shape[1] != s or pos.shape[0] not in (1, b):
        raise ValueError(f"positions must be (1 or {b}, {s}); got {tuple(pos.shape)}")
    return pos.to(device=device, dtype=torch.int32).expand(b, s).contiguous()


def _launch(q, k, v, causal: bool, window: int | None, q_positions, kv_positions):
    """Check the inputs and launch the kernel; raises on what it does not
    take or on a failed launch."""
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("flash_mha: q, k, v must lie on one CUDA device")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_mha: dtypes {q.dtype}/{k.dtype}/{v.dtype}; "
                        "need one of float32, bfloat16 for all three")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_mha: shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    b, sq, hq, d = q.shape
    _, skv, hkv, dk = k.shape
    if k.shape[0] != b or dk != d or hq % hkv or d not in HEAD_DIMS:
        raise ValueError(f"flash_mha: unsupported shapes q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)} (head_dim in {HEAD_DIMS}, "
                         "Hq a multiple of Hkv)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_mha: q, k, v must be contiguous")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("flash_mha: q, k, v must be 16-byte aligned")
    if window is not None and window < 1:
        raise ValueError(f"flash_mha: window must be >= 1; got {window}")
    qp = kp = None
    if q_positions is not None or kv_positions is not None:
        qp = _positions(q_positions, b, sq, q.device)
        kp = _positions(kv_positions, b, skv, q.device)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        err = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            qp.data_ptr() if qp is not None else None,
            kp.data_ptr() if kp is not None else None,
            b, sq, skv, hq, hkv, d, int(causal), window or 0,
            int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_mha: kernel launch failed with CUDA error {err}")
    flash_mha.launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """Forward: the kernel on CUDA tensors, the plain version on CPU
    tensors.  Backward: autograd of the plain version on the saved inputs,
    with the forward's mask arguments (no gradient for the positions)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_positions, kv_positions):
        ctx.save_for_backward(q, k, v, q_positions, kv_positions)
        ctx.kw = dict(causal=causal, window=window)
        if q.device.type == "cpu":
            return mha_ref(q, k, v, q_positions=q_positions, kv_positions=kv_positions,
                           **ctx.kw)
        return _launch(q, k, v, causal, window, q_positions, kv_positions)

    @staticmethod
    def backward(ctx, grad_out):
        q, k, v, q_positions, kv_positions = ctx.saved_tensors

        def plain(q, k, v):
            return mha_ref(q, k, v, q_positions=q_positions, kv_positions=kv_positions,
                           **ctx.kw)
        return (*plain_grads(plain, (q, k, v), ctx.needs_input_grad, (grad_out,)),
                None, None, None, None)


def flash_mha(q, k, v, *, causal: bool = True, window: int | None = None,
              q_positions=None, kv_positions=None):
    """q: (B, Sq, Hq, D); k/v: (B, Skv, Hkv, D).  Returns (B, Sq, Hq, D).

    CPU tensors take the plain version ``mha_ref``; CUDA tensors launch the
    kernel or raise.  Differentiable in q, k and v."""
    return _FlashAttention.apply(q, k, v, causal, window, q_positions, kv_positions)


flash_mha.launches = 0


def kernel_info(d: int) -> dict:
    """Registers, spill bytes, shared memory and blocks per SM of the bf16
    kernel (without positions) at head_dim ``d``."""
    return build.tile_info("flash_attention", "repro_flash_mha_bf16_info", d)
