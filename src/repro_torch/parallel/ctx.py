"""The sharding context, after the JAX package's ``parallel/ctx.py``.

In JAX the context tells GSPMD how key intermediates are laid out
(``constrain`` is ``with_sharding_constraint``).  The port has no
partitioner: a sharded entry point runs every rank's local computation
itself (``parallel/steps.py``), so ``constrain`` is the identity on a local
block.  What the context adds here is the mesh and each rank's coordinates:
the sharded model code reads them to find a rank's local heads, experts
and vocabulary range (``tp_index``), and gathers a rank's FSDP-sharded
weights through it (``local``).

Outside a context (single-device runs) nothing changes.  The sharded
entry points hold their context explicitly as well, since a recomputed
layer (remat) runs in the backward, after the ``with`` block has closed.
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple, Optional

from repro_torch.parallel import collectives as C
from repro_torch.parallel.layout import P, ShardedTensor, axes_of, tree_map

_TLS = threading.local()

BATCH = "@batch"   # placeholder resolved to the context's batch axes
TP = "@tp"         # placeholder resolved to the context's tensor axis

# The JAX dry run's batch-1 rule (``launch/dryrun.py`` ``_cache_specs_tree``):
# a cache of one row whose slot count SEQ_DIV divides and is at least
# SEQ_MIN splits its slots over the DATA axis.
DATA = "data"
SEQ_DIV, SEQ_MIN = 16, 4096


class Slots(NamedTuple):
    """A rank's block [start, stop) of a decode cache's ``cap`` slots, which
    split over the mesh ``axes`` in ceil-sized blocks (``Layout.regions``'
    cut; the last blocks shorter or empty)."""
    start: int
    stop: int
    cap: int
    axes: tuple

    def length(self, t: int) -> int:
        """Valid slots of the block when the token at position t is in:
        the valid slots of a linear cache, and of a ring, are the prefix
        [0, min(t + 1, cap))."""
        return min(max(min(t + 1, self.cap) - self.start, 0), self.stop - self.start)

    def local(self, slot: int) -> Optional[int]:
        """``slot``'s index within the block, or None where another rank
        holds it."""
        return slot - self.start if self.start <= slot < self.stop else None


class ShardingCtx:
    def __init__(self, mesh, batch_axes, tp_axis: Optional[str] = "model"):
        self.mesh = mesh
        self.batch_axes = tuple(a for a in (batch_axes or ()) if a)
        self.tp_axis = tp_axis
        self.copies = None  # a whole block's: the axis its copies' gradients are whole over

    def resolve(self, dims) -> P:
        parts = []
        for d in dims:
            if d == BATCH:
                ba = self.batch_axes
                parts.append(ba if len(ba) > 1 else (ba[0] if ba else None))
            elif d == TP:
                parts.append(self.tp_axis)
            else:
                parts.append(d)
        return P(*parts)

    # ------------------------------------------------------------- ranks
    @property
    def ranks(self) -> tuple:
        """Every logical device of the mesh, in mesh order."""
        return self.mesh.device_ids

    def _size(self, axes) -> int:
        return C.axis_size(self.mesh, axes) if axes else 1

    @property
    def tp_size(self) -> int:
        return self._size((self.tp_axis,) if self.tp_axis else ())

    def tp_index(self, rank: int) -> int:
        return C.axis_index(self.mesh, self.tp_axis, rank) if self.tp_axis else 0

    def tp_splits(self, st: ShardedTensor, dim: int) -> bool:
        """Whether the tensor axis shards dim ``dim`` of ``st``
        (``sanitize_specs`` drops it from a dim it does not divide)."""
        spec = st.layout.spec
        return (bool(self.tp_axis) and self.tp_size > 1 and dim < len(spec)
                and self.tp_axis in axes_of(spec[dim]))

    def whole(self, full_grads: bool = True) -> "ShardingCtx":
        """The context of a block whose layout the tensor axis leaves whole
        (``sanitize_specs`` dropped the axis from the block's defining
        weight, as the JAX package's GSPMD then replicates the block): the
        same mesh and batch axes without a tensor axis.  Every tensor rank
        computes the whole block on its own copy and keeps its own result,
        so the block's output reaches each rank once and is never summed
        over the tensor axis (``tp_reduce`` is the identity here); its
        ``local`` gathers a leaf over every axis, the tensor axis too where
        the layout still splits one.

        ``full_grads``: the block's output gradient reaches every copy whole
        (``transformer.block_sharded`` routes it so, ``tp_grad_sum``), so
        each copy's weight gradient is the whole gradient and is not summed
        over the tensor axis; ``local`` then keeps the gradient of a leaf it
        gathers over that axis on the axis's first rank only (the gather's
        backward sums the copies).  Without it each copy's gradient is its
        own rank's share, summed over the axis with the other replicated
        leaves'."""
        c = ShardingCtx(self.mesh, self.batch_axes, None)
        c.copies = self.tp_axis if full_grads else None
        return c

    def tp_grad_sum(self, xs: dict) -> dict:
        """The identity; its backward all-reduces the gradient over the
        tensor axis (each rank's share of it becomes the whole on every
        rank)."""
        if not self.tp_axis or not any(x.requires_grad for x in xs.values()):
            return xs
        return C.grad_all_reduce(xs, self.mesh, self.tp_axis)

    def tp_grad_root(self, xs: dict) -> dict:
        """The identity; its backward keeps the gradient on the tensor
        axis's first rank and gives the others none (a gradient whole on
        every rank becomes one share per rank, the root's the whole)."""
        if not self.tp_axis:
            return xs
        return _root_grads(xs, self.mesh, self.tp_axis)

    @property
    def batch_size(self) -> int:
        """Data-parallel replicas (the product of the batch axes)."""
        return self._size(self.batch_axes)

    def batch_index(self, rank: int) -> int:
        return C.axis_index(self.mesh, self.batch_axes, rank) if self.batch_axes else 0

    def seq_axes(self, by_slot: bool, rows: int, cap: int) -> tuple:
        """The mesh axes a rank's decode cache of ``rows`` rows and ``cap``
        slots splits its slots over: the data axis where the cache has no
        batch axis, one row and a slot count the JAX rule splits (SEQ_DIV,
        SEQ_MIN), then the tensor axis where ``by_slot`` (it does not
        divide the KV heads, ``transformer.seq_split``)."""
        axes = ()
        if (not self.batch_axes and rows == 1 and self.mesh.shape.get(DATA, 1) > 1
                and cap % SEQ_DIV == 0 and cap >= SEQ_MIN):
            axes += (DATA,)
        if by_slot and self.tp_size > 1:
            axes += (self.tp_axis,)
        return axes

    def slots(self, axes: tuple, cap: int, rank: int) -> Slots:
        """``rank``'s block of ``cap`` slots split over ``axes``."""
        size = -(-cap // self._size(axes))
        i = C.axis_index(self.mesh, axes, rank)
        return Slots(min(cap, i * size), min(cap, (i + 1) * size), cap, axes)

    # ------------------------------------------------------- collectives
    def tp_reduce(self, xs: dict, op: str = "sum") -> dict:
        """All-reduce over the tensor axis (the row-parallel output)."""
        if not self.tp_axis:
            return xs
        return C.all_reduce(xs, self.mesh, self.tp_axis, op=op)

    def lse_merge(self, outs: dict, lses: dict, axes: tuple) -> dict:
        """{rank: the fp32 attention rows} of the ranks' partials over their
        slot blocks, merged over ``axes`` by log-sum-exp
        (``collectives.lse_merge``)."""
        return C.lse_merge(outs, lses, self.mesh, axes)

    def batch_reduce(self, xs: dict) -> dict:
        """All-reduce (sum) over the batch axes (data-parallel replicas)."""
        if not self.batch_axes:
            return xs
        return C.all_reduce(xs, self.mesh, self.batch_axes)

    def tp_gather(self, xs: dict, dim: int, size: Optional[int] = None) -> dict:
        """All-gather along ``dim`` over the tensor axis (its backward is
        the reduce-scatter); with ``size``, blocks that already hold
        ``size`` there (a weight ``sanitize_specs`` left unsplit) come back
        as they are."""
        if not self.tp_axis or (size is not None
                                and next(iter(xs.values())).shape[dim] == size):
            return xs
        return C.all_gather(xs, self.mesh, self.tp_axis, dim)

    def batch_gather(self, xs: dict, dim: int = 0) -> dict:
        """All-gather along ``dim`` over the batch axes, replica 0 first."""
        if not self.batch_axes:
            return xs
        return C.all_gather(xs, self.mesh, self.batch_axes, dim)

    def local(self, tree) -> dict:
        """{rank: the rank's compute view of ``tree``}: every
        ``ShardedTensor`` leaf's block all-gathered over each mesh axis but
        the tensor axis that shards it (the FSDP gather; autograd's
        backward of it is the reduce-scatter), so a block is left sharded
        on the tensor axis only.  Other leaves go to every rank as they
        are."""
        gathered = tree_map(lambda st: _Ranks(self._gather(st))
                            if isinstance(st, ShardedTensor) else st, tree)
        return {r: tree_map(lambda g, r=r: g.blocks[r] if isinstance(g, _Ranks) else g,
                            gathered)
                for r in self.ranks}

    def _gather(self, st: ShardedTensor) -> dict:
        blocks = fsdp_gather(st, self.tp_axis)
        if self.copies and any(self.copies in axes_of(part) for part in st.layout.spec):
            blocks = _root_grads(blocks, self.mesh, self.copies)
        return blocks


def _root_grads(xs: dict, mesh, axis) -> dict:
    """{rank: x}, detached but on the first rank of each group of ``axis``."""
    return {r: x if C.axis_index(mesh, axis, r) == 0 else x.detach() for r, x in xs.items()}


class _Ranks:
    """A per-rank dict held as one tree leaf."""

    def __init__(self, blocks: dict):
        self.blocks = blocks


def fsdp_gather(st: ShardedTensor, tp_axis) -> dict:
    """{rank: block} of ``st`` gathered over every axis of its spec other
    than ``tp_axis``."""
    blocks = dict(st.blocks)
    mesh = st.layout.mesh
    for dim, part in enumerate(st.layout.spec):
        axes = tuple(a for a in axes_of(part) if a != tp_axis)
        if not axes:
            continue
        if len(axes) != len(axes_of(part)):
            raise ValueError(f"dim {dim} of {st!r} is sharded over the tensor axis "
                             f"{tp_axis!r} together with {axes}; not supported")
        blocks = C.all_gather(blocks, mesh, axes, dim)
    return blocks


def current() -> Optional[ShardingCtx]:
    return getattr(_TLS, "ctx", None)


@contextlib.contextmanager
def use(mesh, batch_axes, tp_axis: Optional[str] = "model"):
    prev = current()
    _TLS.ctx = ShardingCtx(mesh, batch_axes, tp_axis)
    try:
        yield _TLS.ctx
    finally:
        _TLS.ctx = prev


def constrain(x, *dims, divisible: bool = True):
    """The identity: ``x`` is a rank's local block, already laid out.  (JAX's
    ``with_sharding_constraint``; the port's sharded code places every
    block itself.)"""
    return x
