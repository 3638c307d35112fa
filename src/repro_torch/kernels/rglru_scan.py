"""RG-LRU linear recurrence: the hand-written CUDA kernel
``csrc/rglru_scan.cu``, its plain version and its gradient.

Counterpart of the JAX package's Pallas kernel ``kernels/rglru_scan.py``
``rglru_pallas``.  Like that kernel it starts from a zero carry: an
``init_state`` raises on the card (the reference tier takes one).

The kernel is a chunked single-pass scan: S is cut into chunks of
``rglru_chunks`` steps, one block per (128-channel tile, chunk, row); each
block copies its chunk of a and bx into shared memory, computes the chunk's
aggregate, takes its incoming carry from the chunks before it (up to
``CLUSTER`` chunks form a thread-block cluster and compose their aggregates
in chunk order through distributed shared memory; a longer S is walked in
windows of one cluster) and walks the chunk again to write h.  a and bx are
read once and h written once; two launches on the same inputs give the same
bits.

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
TILE = 128                # channels per block
CHUNKS = (8, 16, 32, 64)  # chunk lengths rglru_chunks chooses among; the kernel takes 1-64
CLUSTER = 8               # most chunks per cluster (the portable cluster size)


@functools.cache
def _entry():
    """The kernel's C entry point, typed once when its library loads."""
    fn = build.library("rglru_scan").repro_rglru_scan
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rglru_grid(s: int, chunk: int) -> tuple[int, int]:
    """(chunks per cluster, windows) of the launch at ``chunk`` steps per
    block: S's chunks go to clusters of up to CLUSTER, walked in windows."""
    n = -(-s // chunk)
    cluster = min(CLUSTER, n)
    return cluster, -(-n // cluster)


def rglru_chunks(b: int, s: int, w: int, sms: int) -> int:
    """Steps per block, from shapes alone.  Among CHUNKS (each cut to S
    rounded up to 8; 64 only where one window holds S, since its two stages
    of shared memory leave one block per SM), the chunk with the fewest
    windows (each one more serial round of the cluster), then with the most
    blocks (W / TILE x cluster x B) up to one per SM on ``sms`` SMs, then
    the nearest 32 steps.  On an H100, ``scripts/rglru_chunk_sweep.py``
    reads this pick fastest at most of recurrentgemma's admission shapes
    and within 15% of the fastest chunk at the others.
    recurrentgemma-9b (W 4096) at 1 row of 256 takes 32 (256 blocks), at 4
    rows of 512 64 (1,024)."""
    tiles = -(-w // TILE)

    def key(c):
        cluster, windows = rglru_grid(s, c)
        return -windows, min(tiles * b * cluster, sms), -abs(c - 32)
    cands = {min(c, -(-s // 8) * 8) for c in CHUNKS}
    cands = {c for c in cands if c < CHUNKS[-1] or rglru_grid(s, c)[1] == 1} or cands
    return max(cands, key=key)


def _launch(a, bx, init_state, chunk):
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
    if chunk is None:
        chunk = rglru_chunks(b, s, w, build.sm_count(a.device.index))
    if not 1 <= chunk <= CHUNKS[-1]:
        raise ValueError(f"rglru_scan: chunk {chunk}; the kernel takes 1-{CHUNKS[-1]}")
    h = torch.empty_like(bx)
    final = torch.empty((b, w), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        err = _entry()(a.data_ptr(), bx.data_ptr(), h.data_ptr(), final.data_ptr(), b, s, w,
                       int(a.dtype == torch.bfloat16), chunk, rglru_grid(s, chunk)[0],
                       torch.cuda.current_stream(a.device).cuda_stream)
    if err:
        raise RuntimeError(f"rglru_scan: kernel launch failed with CUDA error {err}")
    rglru_scan.launches += 1
    return h, final


class _RGLRUScan(torch.autograd.Function):
    """Forward: the kernel on CUDA tensors, the plain version on CPU
    tensors.  Backward: ``rglru_scan_bwd_ref`` on the saved inputs."""

    @staticmethod
    def forward(ctx, a, bx, init_state, chunk):
        ctx.save_for_backward(a, bx, init_state)
        if a.device.type == "cpu":
            return rglru_scan_ref(a, bx, init_state)
        return _launch(a, bx, init_state, chunk)

    @staticmethod
    def backward(ctx, grad_h, grad_final):
        return *rglru_scan_bwd_ref(*ctx.saved_tensors, grad_h, grad_final), None


def rglru_scan(a, bx, init_state=None, *, chunk: int | None = None):
    """a, bx: (B, S, W), one dtype.  Returns (h (B, S, W) in bx's dtype,
    the final state (B, W) fp32).

    CPU tensors take the plain version ``rglru_scan_ref``; CUDA tensors
    launch the kernel or raise.  ``chunk`` (default ``rglru_chunks``) sets
    the kernel's steps per block; it moves only the association of the
    chunk carries.  Differentiable in a, bx and (on the CPU)
    ``init_state``."""
    return _RGLRUScan.apply(a, bx, init_state, chunk)


rglru_scan.launches = 0


def kernel_info(dtype: torch.dtype, chunk: int) -> dict:
    """Registers, spill bytes, shared memory and blocks per SM of the body
    at ``chunk`` steps (one stage) for ``dtype`` inputs."""
    return build.tile_info("rglru_scan", "repro_rglru_scan_info",
                           (chunk << 1) | int(dtype == torch.bfloat16))
