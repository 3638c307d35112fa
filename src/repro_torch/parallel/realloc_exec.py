"""Parameter-reallocation executor: move a parameter tree from one layout to
another, the port's counterpart of the JAX package's
``parallel/realloc_exec.py``.

The schedule model lives in ``core/realloc.py`` (the paper's Fig. 6
algorithm); this file executes a move with block copies.  Each leaf is a
``parallel/layout.ShardedTensor`` (or a plain tensor, which a move places
onto its layout), and a destination layout (``Layout``) gives every logical
device of its mesh one block.  A move fills each destination block from the
source blocks whose regions it overlaps, taking each piece from a holder on
the same logical device if there is one, else on the same physical device,
else the first in mesh order.  On CUDA the copies of one reshard run on a
side stream per destination card (after the streams the blocks were made
on), and the task records one event per side stream: ``done()`` polls the
events, ``wait()`` synchronises on them.  Same-mesh and cross-mesh moves
(disjoint device sets) are the same copies here; on one card they run
through HBM, on four cards a block on another card is a peer copy.

Byte-accurate dispatch: before any copy the tree is split into the leaves
whose layout changes and the leaves already laid out as requested
(``Layout.is_equivalent_to``, JAX's test).  Only the moved leaves are
copied; unchanged leaves alias: they are returned as the very same objects.
``ReshardTask`` records the split (``moved_bytes`` / ``total_bytes`` / leaf
counts), counting each leaf's *global* bytes once whatever its replication,
so the runtime can fold measured transfer times back into the estimator's
reallocation cost model.

Donation (``donate=True``, the default): the leaves move one after
another, and a moved ``ShardedTensor`` releases its source blocks as soon
as its copies are enqueued (``record_stream`` keeps the allocator from
handing their memory out before the side stream has read them; a later
leaf's blocks may then take it), and a destination block whose region the
same logical device already holds on the same card takes over that source
block without a copy.  The donated tensor raises on use afterwards, as a
donated JAX array does.  Peak memory stays at or below source +
destination.  ``clone_reshard`` donates nothing and keeps the source
valid.

Differences from the JAX file, each for torch: a leaf whose destination is
None keeps its place (aliases); a leaf that is no tensor (the AdamW step
counter, a Python int) is host state, aliases and counts no bytes;
``dispatched_at`` is stamped before the copies are enqueued, since a copy
between host tensors runs inside the dispatch.

``prefetch_reshard`` returns a ``ReshardTask`` as soon as the copies are
enqueued, so the runtime can overlap the transfer with other calls (paper
§6: reallocation hidden behind the critical path).
"""

from __future__ import annotations

import dataclasses
import functools
import time
from typing import Any, Optional

import torch

from repro_torch.parallel.layout import (Layout, ShardedTensor, intersect, region_shape,
                                         slices, tree_leaves, tree_map)

_SIDE_STREAMS: dict = {}


def _side_stream(device: torch.device):
    s = _SIDE_STREAMS.get(device)
    if s is None:
        s = _SIDE_STREAMS[device] = torch.cuda.Stream(device=device)
    return s


def _is_tensor(leaf) -> bool:
    return isinstance(leaf, (torch.Tensor, ShardedTensor))


def _leaf_bytes(leaf) -> int:
    if isinstance(leaf, ShardedTensor):
        return leaf.nbytes
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    return 0


def _unchanged(leaf, dst) -> bool:
    """True when the leaf is already laid out exactly as requested (or has
    no layout to take), so the reshard may alias it."""
    if dst is None or not _is_tensor(leaf):
        return True
    if not isinstance(leaf, ShardedTensor):
        return False
    if leaf.layout.device_set != dst.device_set:
        return False
    return leaf.layout.is_equivalent_to(dst, leaf.ndim)


@functools.lru_cache(maxsize=1024)
def _copy_plan(src: Optional[Layout], dst: Layout, shape: tuple, take_over: bool) -> tuple:
    """How a leaf of ``shape`` on ``src`` (None: one plain tensor) fills
    ``dst``: per destination device (logical id, block shape, whether it
    takes over the source block of the same id, [(destination slices,
    source holder id, source slices)]).  Each piece comes from a holder on
    the same logical device if there is one, else on the same card, else
    the first in mesh order.  Many leaves share a (layout, shape) pair, so
    the plan is computed once per pair."""
    holders: dict = {}  # region -> [(logical id, card)]
    if src is None:
        holders[tuple((0, n) for n in shape)] = [(None, None)]
    else:
        for d, reg in src.regions(shape):
            holders.setdefault(reg, []).append((d, src.mesh.torch_device(d)))
    plan = []
    for d, reg in dst.regions(shape):
        card = dst.mesh.torch_device(d)
        if take_over and (d, card) in holders.get(reg, ()):
            plan.append((d, region_shape(reg), True, ()))
            continue
        pieces = []
        for sreg, hs in holders.items():
            part = intersect(reg, sreg)
            if part is None:
                continue
            h = next((h for h, c in hs if h == d),
                     next((h for h, c in hs if c == card), hs[0][0]))
            pieces.append((slices(part, reg), h, slices(part, sreg)))
        plan.append((d, region_shape(reg), False, tuple(pieces)))
    return tuple(plan)


class _Dispatch:
    """The copies of one reshard, leaf by leaf: a leaf's destination blocks
    are allocated, the side streams wait for the streams its blocks were
    made on, its copies are enqueued, and with donation its source blocks
    are released at once, so a later leaf's blocks can take their memory
    once the side stream has read them."""

    def __init__(self, donate: bool):
        self.donate = donate
        self.streams: dict = {}  # destination card -> side stream

    def move(self, leaf, dst: Layout) -> ShardedTensor:
        sharded = isinstance(leaf, ShardedTensor)
        donated = self.donate and sharded
        plan = _copy_plan(leaf.layout if sharded else None, dst, tuple(leaf.shape), donated)
        src = leaf.blocks if sharded else {None: leaf.detach()}
        blocks, copies = {}, []
        for d, shape, reuse, pieces in plan:
            if reuse:  # the device already holds this block: take it over
                blocks[d] = src[d]
                continue
            out = torch.empty(shape, dtype=leaf.dtype, device=dst.mesh.torch_device(d))
            copies += [(out, osl, src[h], ssl) for osl, h, ssl in pieces]
            blocks[d] = out
        self._enqueue(copies)
        if donated:
            leaf._release()
        return ShardedTensor(leaf.shape, leaf.dtype, dst, blocks)

    def _enqueue(self, copies):
        by_card: dict = {}
        for c in copies:
            if c[0].is_cuda:
                by_card.setdefault(c[0].device, []).append(c)
            else:
                c[0][c[1]].copy_(c[2][c[3]])
        involved = {t.device for c in copies for t in (c[0], c[2]) if t.is_cuda}
        for dev, todo in by_card.items():
            s = self.streams[dev] = _side_stream(dev)
            for other in involved:  # after the work that made these blocks
                s.wait_stream(torch.cuda.current_stream(other))
            with torch.cuda.stream(s):
                for out, osl, blk, bsl in todo:
                    out[osl].copy_(blk[bsl], non_blocking=True)
            # neither block's memory is handed out again before s is done
            for t in {id(t): t for c in todo for t in (c[0], c[2]) if t.is_cuda}.values():
                t.record_stream(s)

    def events(self) -> list:
        out = []
        for s in self.streams.values():
            ev = torch.cuda.Event()
            ev.record(s)
            out.append(ev)
        return out


def _flatten_up_to(tree, dst_tree) -> tuple[list, list]:
    """(leaves of ``tree``, the destination at each leaf's place)."""
    pairs = []
    tree_map(lambda x, d: pairs.append((x, d)), tree, dst_tree)
    return [p[0] for p in pairs], [p[1] for p in pairs]


def _reshard_impl(tree, dst_tree, donate: bool):
    """Returns (out tree, moved_bytes, total_bytes, n_moved, n_aliased,
    events)."""
    leaves, dst = _flatten_up_to(tree, dst_tree)
    moves = [not _unchanged(x, d) for x, d in zip(leaves, dst)]
    tensors = [x for x in leaves if _is_tensor(x)]
    total = sum(_leaf_bytes(x) for x in tensors)
    n_moved = sum(moves)
    n_aliased = len(tensors) - n_moved
    if n_moved == 0:  # pure alias: nothing to dispatch
        return tree, 0, total, 0, n_aliased, []
    moved_bytes = sum(_leaf_bytes(x) for x, m in zip(leaves, moves) if m)
    dispatch = _Dispatch(donate)
    new = {}
    for x, d, m in zip(leaves, dst, moves):
        if m and id(x) not in new:  # a leaf shared by two places moves once
            new[id(x)] = dispatch.move(x, d)
    out = tree_map(lambda x: new.get(id(x), x), tree)
    return out, moved_bytes, total, n_moved, n_aliased, dispatch.events()


def reshard(tree, dst_layout_tree, *, donate: bool = True):
    """Reallocate ``tree`` to the layouts in ``dst_layout_tree`` and return
    the new tree once the copies have landed.  Leaves already laid out as
    requested are returned as they are (alias, zero bytes moved).  With
    ``donate`` (the default) the moved leaves' source blocks are released:
    the caller must not reuse ``tree`` afterwards."""
    return prefetch_reshard(tree, dst_layout_tree, donate=donate).wait()


@dataclasses.dataclass
class ReshardTask:
    """Handle to an asynchronously dispatched reshard.

    ``tree`` holds the destination tensors at once; their copies complete in
    the background on side streams.  ``wait()`` blocks until they land and
    returns the tree; ``done()`` polls.  ``moved_bytes``/``total_bytes``
    record the byte-accurate split, and ``elapsed_s`` (set once the transfer
    is observed complete) feeds the estimator's measured reallocation cost
    model."""

    tree: Any
    dispatched_at: float
    moved_bytes: int = 0
    total_bytes: int = 0
    n_moved: int = 0
    n_aliased: int = 0
    elapsed_s: Optional[float] = None
    events: list = dataclasses.field(default_factory=list, repr=False)

    def done(self) -> bool:
        if not all(ev.query() for ev in self.events):
            return False
        if self.elapsed_s is None:
            self.elapsed_s = time.monotonic() - self.dispatched_at
        return True

    def wait(self):
        for ev in self.events:
            ev.synchronize()
        if self.elapsed_s is None:
            self.elapsed_s = time.monotonic() - self.dispatched_at
        return self.tree


def prefetch_reshard(tree, dst_layout_tree, *, donate: bool = True) -> ReshardTask:
    """Kick off ``reshard`` without blocking on the transfer.

    Returns a :class:`ReshardTask` whose ``tree`` may be handed to later
    work once ``wait()`` returned (usually at once: callers dispatch this
    early and wait right before use).  As with ``reshard``, ``donate=True``
    invalidates the moved source leaves (unchanged leaves are aliased, not
    donated: they stay valid by identity)."""
    t0 = time.monotonic()
    out, moved, total, n_moved, n_aliased, events = _reshard_impl(
        tree, dst_layout_tree, donate)
    return ReshardTask(out, t0, moved, total, n_moved, n_aliased, events=events)


def clone_reshard(tree, dst_layout_tree):
    """Non-donating copy of ``tree`` onto ``dst_layout_tree``.

    The source stays valid: the runtime's speculative straggler re-dispatch
    needs it, where the original call is still computing on the source
    blocks while a duplicate races it on an idle mesh.  Leaves already laid
    out as requested alias as usual (read-only for both racers)."""
    return reshard(tree, dst_layout_tree, donate=False)


def realloc_bytes(tree) -> int:
    """The global bytes of every tensor leaf of ``tree``."""
    return sum(_leaf_bytes(x) for x in tree_leaves(tree))
