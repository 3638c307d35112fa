"""Paged (block-pool) KV cache: allocator, cache construction, prefill insert.

Full-attention layers share a pool of ``n_blocks`` fixed-size blocks,
``(n_blocks, block_size, Hkv, Dh)`` per layer, and each sequence owns a list
of physical block ids, laid out as a block-table row ``(max_blocks,)``.  The
table is shared by all layers, so allocation is one host-side free-list
operation per ``block_size`` generated tokens, and a finished sequence's
blocks are reusable at once by queued requests (continuous batching).

Physical block 0 is reserved as a scratch block: inactive server slots and
unallocated table entries point at it, so the fixed-shape decode step runs
over every slot unconditionally; their writes land in scratch and their
reads are masked by ``cache_len``.

Sliding-window layers keep O(window) per-slot ring buffers and recurrent
mixers (RG-LRU, SSD) per-slot states.  The allocator and the byte
accounting are copies of the JAX package's ``models/paged_cache.py``; the
cache is a list with one dict per layer (the port's layout: ``{"k", "v"}``
for attention, the mixer's state leaves otherwise), updated in place.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ATTN, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

RESERVED_BLOCKS = 1  # physical block 0 = scratch for inactive slots


def needed_blocks(n_tokens: int, block_size: int) -> int:
    return -(-n_tokens // block_size)


class BlockAllocator:
    """Host-side free-list allocator over the physical block pool.

    Invariants (enforced): a block is owned by at most one sequence; free
    of an unowned block raises; block 0 is never handed out.  Tracks the
    in-use high-water mark for peak-memory accounting."""

    def __init__(self, n_blocks: int, block_size: int):
        if n_blocks <= RESERVED_BLOCKS:
            raise ValueError(f"pool needs > {RESERVED_BLOCKS} blocks, "
                             f"got {n_blocks}")
        self.n_blocks = n_blocks
        self.block_size = block_size
        self._free = list(range(n_blocks - 1, RESERVED_BLOCKS - 1, -1))
        self._used: set[int] = set()
        self.peak = 0

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used_count(self) -> int:
        return len(self._used)

    def alloc(self, n: int) -> list[int]:
        if n > len(self._free):
            raise MemoryError(f"asked for {n} blocks, {len(self._free)} free")
        ids = [self._free.pop() for _ in range(n)]
        self._used.update(ids)
        self.peak = max(self.peak, len(self._used))
        return ids

    def free(self, ids) -> None:
        for i in ids:
            if i not in self._used:
                raise ValueError(f"double/foreign free of block {i}")
            self._used.remove(i)
            self._free.append(i)

    def truncate_to(self, blocks: list[int], n_tokens: int) -> list[int]:
        """Free the tail of a sequence's block list in one call, keeping just
        enough blocks to cover ``n_tokens`` tokens.  Returns the retained
        prefix (a new list; the input is not mutated).  Completion and
        preemption call it with ``n_tokens=0`` (free everything)."""
        keep = needed_blocks(n_tokens, self.block_size) if n_tokens > 0 else 0
        if keep > len(blocks):
            raise ValueError(
                f"truncate_to({n_tokens}) needs {keep} blocks, "
                f"sequence owns {len(blocks)}")
        self.free(blocks[keep:])
        return list(blocks[:keep])

    def reset_peak(self) -> None:
        self.peak = len(self._used)


# ------------------------------------------------------------- construction

def paged_cache_init(cfg: ModelConfig, n_slots: int, n_blocks: int,
                     block_size: int, max_len: int, dtype, device):
    """Per-layer decode caches for paged serving: ``{"k", "v"}`` pools of
    shape ``(n_blocks, block_size, Hkv, Dh)`` for full-attention layers,
    per-slot rings ``(n_slots, min(window, max_len), Hkv, Dh)`` for window
    layers, per-slot states (``transformer.layer_cache_init`` of
    ``n_slots`` rows) for recurrent mixers.  An encoder-decoder is refused
    (its cross k/v has no paged layout), as in the JAX package."""
    if cfg.family == "encdec":
        raise ValueError("paged serving does not support encdec configs")
    caches = []
    for spec in cfg.layers:
        if spec.kind == ATTN and spec.window is None:
            shape = (n_blocks, block_size, cfg.n_kv_heads, cfg.head_dim)
            caches.append({"k": torch.zeros(shape, dtype=dtype, device=device),
                           "v": torch.zeros(shape, dtype=dtype, device=device)})
        else:
            caches.append(T.layer_cache_init(cfg, spec, n_slots, max_len, dtype, device))
    return caches


def paged_insert(cfg: ModelConfig, caches, dense_caches, slots, table_rows,
                 prompt_len: int, *, n_slots: int):
    """Scatter a batch of dense prefill caches into the paged caches, in
    place.

    ``dense_caches``: from ``model.prefill`` on a (W, prompt_len) batch
    (per layer (W, >= prompt_len, Hkv, Dh) for full layers, rings for
    window layers, per-row states for recurrent layers, whose rows are
    copied).  ``slots``: (W,) host ints, the server slot of each row;
    rows with a slot >= ``n_slots`` are padding of a partly filled admission
    batch and are not written at all (the JAX scatter drops them as out of
    range; torch indexing would raise, and their table rows all point at
    block 0, whose duplicate writes would land in an undefined order on the
    card).  ``table_rows``: (W, ceil(prompt_len / bs)) host ints, the
    physical blocks covering each prompt.  Returns ``caches``."""
    slots = torch.as_tensor(slots).to("cpu", torch.int64)
    table_rows = torch.as_tensor(table_rows).to("cpu", torch.int64)
    keep = torch.nonzero(slots < n_slots)[:, 0]
    dev = next(iter(caches[0].values())).device
    rows, dst = keep.to(dev), slots[keep].to(dev)
    blocks = None
    for spec, c, d in zip(cfg.layers, caches, dense_caches):
        if spec.kind != ATTN:  # recurrent state: copy the rows
            for name in c:
                c[name][dst] = d[name][rows].to(c[name].dtype)
            continue
        if spec.window is not None:
            cap_d = d["k"].shape[1]  # min(window, prompt_len)
            for name in ("k", "v"):
                c[name][dst, :cap_d] = d[name][rows].to(c[name].dtype)
            continue
        bs = c["k"].shape[1]
        nb = needed_blocks(prompt_len, bs)
        if blocks is None:
            if tuple(table_rows.shape) != (slots.shape[0], nb):
                raise ValueError(f"table_rows {tuple(table_rows.shape)} != "
                                 f"({slots.shape[0]}, {nb})")
            blocks = table_rows[keep].reshape(-1).to(dev)
        for name in ("k", "v"):
            x = d[name][rows, :prompt_len]
            if nb * bs > prompt_len:
                x = F.pad(x, (0, 0, 0, 0, 0, nb * bs - prompt_len))
            c[name][blocks] = x.reshape(-1, bs, *x.shape[2:]).to(c[name].dtype)
    return caches


# --------------------------------------------------------------- accounting

def _kv_bytes_per_token(cfg: ModelConfig) -> int:
    """Bytes of k + v of one token in every full-attention layer."""
    n_full = sum(1 for s in cfg.layers if s.kind == ATTN and s.window is None)
    return n_full * 2 * cfg.n_kv_heads * cfg.head_dim * L.dtype_of(cfg).itemsize


def kv_pool_bytes(cfg: ModelConfig, n_blocks: int, block_size: int) -> int:
    """Bytes of full-attention KV held in ``n_blocks`` pool blocks across
    all layers (k + v), in the config's dtype."""
    return n_blocks * block_size * _kv_bytes_per_token(cfg)


def full_buffer_bytes(cfg: ModelConfig, batch: int, max_len: int) -> int:
    """Bytes of full-attention KV for ``batch`` contiguous ``max_len``
    buffers (the run-to-completion baseline's allocation)."""
    return batch * max_len * _kv_bytes_per_token(cfg)
