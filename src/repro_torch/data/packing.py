"""Packed variable-length batch layout (``cu_seqlens``), as the JAX
package's ``data/packing.py``.

The packed layout concatenates B sequences into one ``(total_tokens,)``
axis with cumulative offsets ``cu_seqlens`` ((B+1,) int32;
``cu_seqlens[i]:cu_seqlens[i+1]`` is sequence i), so varlen attention and
the PPO losses do work in proportion to the real token count.

Layout contract:
* sequences are contiguous and in batch order; ``positions`` restart at 0
  per sequence (RoPE reads them, as the padded forward reads its arange);
* the token axis may be longer than ``cu_seqlens[-1]``: trailing phantom
  tokens (from ``pad_to`` bucketing) belong to no sequence.  Varlen
  attention gives them a segment of their own, every loss mask is 0 there,
  and their ``positions`` are 0;
* lengths are host ints (numpy), as in the JAX package; the packed tensors
  live on the device of the padded input.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class PackedBatch:
    """One packed cohort: tokens (T,), cu_seqlens (B+1,) int32, positions
    (T,) int32 (within-sequence), and ``max_len``, the longest sequence
    (it bands the varlen attention's plain version)."""

    tokens: torch.Tensor
    cu_seqlens: torch.Tensor
    positions: torch.Tensor
    max_len: int

    @property
    def total_tokens(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def n_seqs(self) -> int:
        return int(self.cu_seqlens.shape[0]) - 1


def cu_seqlens_of(lens) -> np.ndarray:
    """(B,) per-sequence lengths -> (B+1,) int32 cumulative offsets."""
    lens = np.asarray(lens, np.int64)
    if not (lens >= 1).all():
        raise ValueError(f"zero-length sequence in {lens}")
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def _flat_indices(lens, row_len: int) -> np.ndarray:
    lens = np.asarray(lens, np.int64)
    if not (lens <= row_len).all():
        raise ValueError(f"a length {lens.max()} exceeds the row length {row_len}")
    return np.concatenate(
        [i * row_len + np.arange(n) for i, n in enumerate(lens)]).astype(np.int64)


def pack(x, lens):
    """Gather the first lens[i] entries of each row: (B, S, ...) -> (T, ...)
    with T = sum(lens).  Differentiable (a gather)."""
    b, s = x.shape[:2]
    idx = torch.from_numpy(_flat_indices(lens, s)).to(x.device)
    return x.reshape((b * s,) + tuple(x.shape[2:])).index_select(0, idx)


def unpack(xp, lens, row_len: int, pad_value=0):
    """Inverse of :func:`pack`: (T, ...) -> (B, S, ...) padded with
    ``pad_value``.  Phantom tokens beyond sum(lens) are dropped."""
    lens = np.asarray(lens, np.int64)
    b, total = len(lens), int(lens.sum())
    idx = torch.from_numpy(_flat_indices(lens, row_len)).to(xp.device)
    flat = torch.full((b * row_len,) + tuple(xp.shape[1:]), pad_value, dtype=xp.dtype,
                      device=xp.device)
    flat = flat.index_copy(0, idx, xp[:total])
    return flat.reshape((b, row_len) + tuple(xp.shape[1:]))


def positions_of(lens) -> np.ndarray:
    """(T,) within-sequence positions (0 .. len_i - 1 per sequence)."""
    lens = np.asarray(lens, np.int64)
    return np.concatenate([np.arange(n) for n in lens]).astype(np.int32)


def segment_ids_of(cu_seqlens, total: int) -> torch.Tensor:
    """(T,) int32 sequence id per token; phantom tokens beyond
    cu_seqlens[-1] get id B (one past the last sequence)."""
    cu = torch.as_tensor(cu_seqlens).to(torch.int64)
    pos = torch.arange(total, device=cu.device)
    return torch.searchsorted(cu[1:], pos, right=True).to(torch.int32)


def pack_batch(tokens, lens) -> PackedBatch:
    """(B, S) padded tokens + host lens -> PackedBatch on the tokens'
    device."""
    lens = np.asarray(lens, np.int64)
    dev = tokens.device
    return PackedBatch(
        tokens=pack(tokens, lens).to(torch.int32),
        cu_seqlens=torch.from_numpy(cu_seqlens_of(lens)).to(dev),
        positions=torch.from_numpy(positions_of(lens)).to(dev),
        max_len=int(lens.max()))


def pad_to(packed: PackedBatch, total: int, pad_id: int = 0) -> PackedBatch:
    """Right-pad the token axis to ``total`` with phantom tokens (mask 0,
    position 0, their own attention segment).  cu_seqlens is unchanged:
    phantoms belong to no sequence."""
    t = packed.total_tokens
    if total < t:
        raise ValueError(f"pad_to {total} below the {t} packed tokens")
    if total == t:
        return packed
    return PackedBatch(tokens=F.pad(packed.tokens, (0, total - t), value=pad_id),
                       cu_seqlens=packed.cu_seqlens,
                       positions=F.pad(packed.positions, (0, total - t)),
                       max_len=packed.max_len)


def bucket_total(t: int, bucket: int = 64) -> int:
    """Round a token count up to the bucket multiple."""
    return -(-t // bucket) * bucket


def check_band(cu_seqlens, max_seqlen):
    """Raise ``ValueError`` where a sequence of ``cu_seqlens`` is longer
    than the band ``max_seqlen`` that the varlen attention's plain version
    is given (it would silently compute another function; None: no band).
    The phantom tail may be longer: its rows carry loss mask 0."""
    if max_seqlen is None:
        return
    longest = int(np.diff(np.asarray(cu_seqlens.tolist())).max(initial=0))
    if longest > max_seqlen:
        raise ValueError(f"a sequence of {longest} tokens exceeds max_seqlen {max_seqlen}")


def _balanced_cuts(cu: list, total: int, n: int) -> list:
    """Sequence indices 0 = c_0 < c_1 < ... < c_n = B that cut B sequences
    at offsets ``cu`` into ``n`` contiguous runs of at least one sequence
    each, cut j at the boundary nearest j / n of the ``total`` tokens (the
    phantom tail counted with the last run)."""
    b = len(cu) - 1
    cuts = [0]
    for j in range(1, n):
        lo, hi = cuts[-1] + 1, b - (n - j)
        target = total * j / n
        cuts.append(min(range(lo, hi + 1), key=lambda i: (abs(cu[i] - target), i)))
    return cuts + [b]


def split_packed(batch: dict, n: int, *, max_seqlen: int | None = None) -> list:
    """Deal a packed cohort to ``n`` batch replicas as contiguous runs of
    whole sequences, in cohort order, balanced by token count: the sharded
    train step's split (the JAX package cuts the (T,) stream evenly and
    lets GSPMD carry attention across the cut; a cut at sequence boundaries
    computes the same function, since the loss is the global masked mean).

    ``batch`` holds "cu_seqlens" (B+1,) and per-token leaves, each (T,)
    ("tokens", "positions") or (1, T) ("labels", "mask"), split along
    their token dim.  The phantom tail past ``cu_seqlens[-1]`` goes to the
    last replica, in order.  Returns ``n`` dicts: each replica's per-token
    leaves, its ``cu_seqlens`` rebased to 0 and "max_seqlen", the longest
    segment of its token axis (its phantom tail one of them), so that the
    varlen attention's banded plain version computes every row of it.
    ``max_seqlen``, where given, must bound every sequence of the cohort
    (``check_band``).  Fewer sequences than replicas raise
    ``ValueError``."""
    cu = [int(c) for c in batch["cu_seqlens"].tolist()]
    total = int(batch["tokens"].shape[-1])
    if len(cu) - 1 < n:
        raise ValueError(f"{len(cu) - 1} sequences cannot fill {n} batch replicas")
    check_band(batch["cu_seqlens"], max_seqlen)
    lens = np.diff(cu)
    for name, v in batch.items():
        if name != "cu_seqlens" and (v.shape[-1] != total or v.dim() > 2
                                     or (v.dim() == 2 and v.shape[0] != 1)):
            raise ValueError(f"batch[{name!r}] has shape {tuple(v.shape)}; a packed leaf "
                             f"is ({total},) or (1, {total})")
    cuts = _balanced_cuts(cu, total, n)
    out = []
    for j in range(n):
        a, b = cuts[j], cuts[j + 1]
        lo, hi = cu[a], (cu[b] if j < n - 1 else total)
        part = {name: v[..., lo:hi] for name, v in batch.items() if name != "cu_seqlens"}
        part["cu_seqlens"] = batch["cu_seqlens"][a:b + 1] - cu[a]
        part["max_seqlen"] = int(max(lens[a:b].max(), hi - cu[b]))
        out.append(part)
    return out


def pack_minibatches(tokens, per_token, lens, n_minibatches: int, bucket: int = 64,
                     max_seqlen: int | None = None):
    """Split B sequences into ``n_minibatches`` contiguous groups (the
    padded path's grouping), pack each group, and stack them at a common
    bucketed token total.

    tokens: (B, S); per_token: dict of token-aligned (B, S) float tensors
    (loss masks must be 0 outside each sequence's valid region); lens: (B,)
    host ints.  ``max_seqlen``, the band the train step's varlen attention
    is given, must bound every length: the banded plain version (the
    reference forward, the kernel tier's backward) silently computes
    another function past it, so a longer sequence raises.  Returns a dict
    of (nmb, ...) stacked tensors: "tokens", "cu_seqlens", "positions" and
    one entry per ``per_token`` key."""
    lens = np.asarray(lens, np.int64)
    b = tokens.shape[0]
    if b % n_minibatches:
        raise ValueError(f"{b} sequences do not split into {n_minibatches} minibatches")
    # the phantom tail past each group's sequences may be longer: its rows
    # carry loss mask 0, so what the band does to them reaches no loss
    if max_seqlen is not None and lens.max(initial=0) > max_seqlen:
        raise ValueError(f"a sequence of {int(lens.max())} tokens exceeds max_seqlen "
                         f"{max_seqlen}")
    gb = b // n_minibatches
    groups = [slice(j * gb, (j + 1) * gb) for j in range(n_minibatches)]
    tmb = bucket_total(int(max(lens[g].sum() for g in groups)), bucket)
    out = {k: [] for k in ("tokens", "cu_seqlens", "positions", *per_token)}
    for g in groups:
        pb = pad_to(pack_batch(tokens[g], lens[g]), tmb)
        out["tokens"].append(pb.tokens)
        out["cu_seqlens"].append(pb.cu_seqlens)
        out["positions"].append(pb.positions)
        for k, v in per_token.items():
            col = pack(v[g], lens[g])
            out[k].append(F.pad(col, (0, tmb - col.shape[0])))
    return {k: torch.stack(v) for k, v in out.items()}
