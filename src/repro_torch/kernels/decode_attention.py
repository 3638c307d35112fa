"""Flash decode (one-token GQA attention over a linear or ring KV cache):
the hand-written CUDA kernel ``csrc/decode_attention.cu`` and its plain
version.

Counterpart of the JAX package's Pallas kernel ``kernels/decode_attention.py``
``flash_decode``.  bf16 inputs run a split-KV grid on tensor cores
(``csrc/decode_split.cuh``: ``decode_splits`` blocks per (row, KV head),
then a merge of their partials); fp32 inputs an fp32-FMA body, one block per
(row, KV head).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.guard import refuse_grad
from repro_torch.kernels.ref import decode_mha_ref

HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)
MAX_GROUP = 16  # query heads per KV head the kernel holds (kMaxG)
SPLIT_TILE = 64  # keys of a tile; a split walks whole tiles
SPLIT_BLOCKS_PER_SM = 2  # blocks in flight per SM the split grid aims at


@functools.cache
def _entry():
    """The kernel's C entry point, typed once when its library loads."""
    fn = build.library("decode_attention").repro_flash_decode
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def decode_splits(b: int, hkv: int, cap: int, sms: int) -> int:
    """Blocks per (batch row, KV head) of the bf16 kernel: enough for about
    SPLIT_BLOCKS_PER_SM blocks on each of ``sms`` SMs, at most one per
    64-key tile of ``cap`` = min(C, window), at least one.  From shapes
    alone: the row lengths stay on the card."""
    tiles = -(-cap // SPLIT_TILE)
    want = -(-SPLIT_BLOCKS_PER_SM * sms // (b * hkv))
    return max(1, min(tiles, want))


def flash_decode(q, k_cache, v_cache, *, cache_len, window: int | None = None,
                 return_lse: bool = False):
    """q: (B, Hq, D); caches: (B, C, Hkv, D); cache_len: (B,) int32.
    Returns (B, Hq, D), or with ``return_lse`` (out, lse): out (B, Hq, D)
    fp32 and lse (B, Hq) fp32, the rows' log-sum-exp; a row with no valid
    key gives out 0 and lse -inf (``decode_mha_ref``).

    CPU tensors take the plain version ``decode_mha_ref``; CUDA tensors
    launch the kernel or raise."""
    if q.device.type == "cpu":
        return decode_mha_ref(q, k_cache, v_cache, cache_len=cache_len,
                              window=window, return_lse=return_lse)
    refuse_grad("flash_decode", q, k_cache, v_cache)
    dev = q.device
    if not (q.is_cuda and k_cache.device == dev and v_cache.device == dev
            and cache_len.device == dev):
        raise ValueError("flash_decode: q, caches and cache_len must lie on one "
                         "CUDA device")
    if q.dtype not in DTYPES or k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"flash_decode: dtypes {q.dtype}/{k_cache.dtype}/"
                        f"{v_cache.dtype}; need one of float32, bfloat16 for all")
    if cache_len.dtype != torch.int32:
        raise TypeError(f"flash_decode: cache_len must be int32; got {cache_len.dtype}")
    if q.dim() != 3 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)}, "
                         f"caches {tuple(k_cache.shape)}/{tuple(v_cache.shape)}")
    b, hq, d = q.shape
    _, cap, hkv, dk = k_cache.shape
    if (k_cache.shape[0] != b or dk != d or d not in HEAD_DIMS or hq % hkv
            or hq // hkv > MAX_GROUP or cap < 1 or tuple(cache_len.shape) != (b,)):
        raise ValueError(f"flash_decode: unsupported shapes q {tuple(q.shape)}, "
                         f"caches {tuple(k_cache.shape)}, cache_len "
                         f"{tuple(cache_len.shape)}")
    if not (q.is_contiguous() and k_cache.is_contiguous()
            and v_cache.is_contiguous() and cache_len.is_contiguous()):
        raise ValueError("flash_decode: inputs must be contiguous")
    if k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16:
        raise ValueError("flash_decode: caches must start 16-byte aligned "
                         "(the kernel reads them in 16-byte loads)")
    if window is not None and window < 1:
        raise ValueError(f"flash_decode: window must be >= 1; got {window}")
    eff_cap = cap if window is None else min(cap, window)
    out = torch.empty(q.shape, dtype=torch.float32 if return_lse else q.dtype, device=dev)
    lse = torch.empty((b, hq), dtype=torch.float32, device=dev) if return_lse else None
    bf16 = q.dtype == torch.bfloat16
    splits = decode_splits(b, hkv, eff_cap, build.sm_count(dev.index)) if bf16 else 1
    # per split and query head: the fp32 accumulator, m and l
    part = (torch.empty(b * hq * splits * (d + 2), dtype=torch.float32, device=dev)
            if bf16 else None)
    with torch.cuda.device(dev):
        err = _entry()(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), out.data_ptr(),
            cache_len.data_ptr(), None if part is None else part.data_ptr(),
            None if lse is None else lse.data_ptr(), b, cap, hq, hkv, d, eff_cap, splits,
            int(bf16), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"flash_decode: kernel launch failed with CUDA error {err}")
    flash_decode.launches += 1
    return (out, lse) if return_lse else out


flash_decode.launches = 0


def kernel_info(d: int) -> dict:
    """Registers, spill bytes, shared memory and blocks per SM of the bf16
    split kernel at head_dim ``d``."""
    return build.tile_info("decode_attention", "repro_flash_decode_bf16_info", d)
