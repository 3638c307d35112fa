"""Paged flash decode (one-token GQA attention over a block-pool KV cache,
read through a block table): the hand-written CUDA kernel
``csrc/paged_decode_attention.cu`` and its plain version.

Counterpart of the JAX package's Pallas kernel
``kernels/paged_decode_attention.py`` ``paged_flash_decode``.  bf16 inputs
run ``flash_decode``'s split-KV grid (``csrc/decode_split.cuh``) with key
rows read through the table, so on the gathered cache the two give the
same bits; fp32 inputs an fp32-FMA body, one block per (row, KV head).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.guard import refuse_grad
from repro_torch.kernels.decode_attention import DTYPES, HEAD_DIMS, MAX_GROUP, decode_splits
from repro_torch.kernels.ref import paged_decode_mha_ref


@functools.cache
def _entry():
    """The kernel's C entry point, typed once when its library loads."""
    fn = build.library("paged_decode_attention").repro_paged_flash_decode
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def paged_flash_decode(q, k_pool, v_pool, block_table, *, cache_len):
    """q: (B, Hq, D); pools: (N, bs, Hkv, D); block_table: (B, M) int32 of
    physical block ids in [0, N); cache_len: (B,) int32.  Returns (B, Hq, D).

    CPU tensors take the plain version ``paged_decode_mha_ref``; CUDA
    tensors launch the kernel or raise (in fp32 also for a table row too
    long for shared memory, over ~37,000 blocks).  The kernel does not
    check the table's entries: one outside [0, N) reads outside the pool.
    bf16 takes ``decode_splits(B, Hkv, M * bs, SMs)`` blocks per (row, KV
    head), from shapes alone."""
    if q.device.type == "cpu":
        return paged_decode_mha_ref(q, k_pool, v_pool, block_table, cache_len=cache_len)
    refuse_grad("paged_flash_decode", q, k_pool, v_pool)
    dev = q.device
    if not (q.is_cuda and all(t.device == dev for t in (k_pool, v_pool, block_table,
                                                         cache_len))):
        raise ValueError("paged_flash_decode: q, pools, block_table and cache_len must "
                         "lie on one CUDA device")
    if q.dtype not in DTYPES or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError(f"paged_flash_decode: dtypes {q.dtype}/{k_pool.dtype}/"
                        f"{v_pool.dtype}; need one of float32, bfloat16 for all")
    if block_table.dtype != torch.int32 or cache_len.dtype != torch.int32:
        raise TypeError(f"paged_flash_decode: block_table and cache_len must be int32; "
                        f"got {block_table.dtype}, {cache_len.dtype}")
    if (q.dim() != 3 or k_pool.dim() != 4 or k_pool.shape != v_pool.shape
            or block_table.dim() != 2):
        raise ValueError(f"paged_flash_decode: shapes q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, table "
                         f"{tuple(block_table.shape)}")
    b, hq, d = q.shape
    _, bs, hkv, dk = k_pool.shape
    m = block_table.shape[1]
    if (block_table.shape[0] != b or dk != d or d not in HEAD_DIMS or hq % hkv
            or hq // hkv > MAX_GROUP or m < 1 or bs < 1
            or tuple(cache_len.shape) != (b,) or m * bs >= 2**31):
        raise ValueError(f"paged_flash_decode: unsupported shapes q {tuple(q.shape)}, "
                         f"pools {tuple(k_pool.shape)}, table {tuple(block_table.shape)}, "
                         f"cache_len {tuple(cache_len.shape)}")
    if not all(t.is_contiguous() for t in (q, k_pool, v_pool, block_table, cache_len)):
        raise ValueError("paged_flash_decode: inputs must be contiguous")
    if k_pool.data_ptr() % 16 or v_pool.data_ptr() % 16:
        raise ValueError("paged_flash_decode: pools must start 16-byte aligned "
                         "(the kernel reads them in 16-byte loads)")
    out = torch.empty_like(q)
    bf16 = q.dtype == torch.bfloat16
    splits = decode_splits(b, hkv, m * bs, build.sm_count(dev.index)) if bf16 else 1
    # per split and query head: the fp32 accumulator, m and l
    part = (torch.empty(b * hq * splits * (d + 2), dtype=torch.float32, device=dev)
            if bf16 else None)
    with torch.cuda.device(dev):
        err = _entry()(
            q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), out.data_ptr(),
            block_table.data_ptr(), cache_len.data_ptr(),
            None if part is None else part.data_ptr(), b, m, bs, hq, hkv, d, splits,
            int(bf16), torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"paged_flash_decode: kernel launch failed with CUDA error {err}")
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0


def kernel_info(d: int) -> dict:
    """Registers, spill bytes, shared memory and blocks per SM of the bf16
    split kernel at head_dim ``d``."""
    return build.tile_info("paged_decode_attention", "repro_paged_flash_decode_bf16_info", d)
