"""Layouts of tensors over a mesh of logical devices: the torch counterpart of
``jax.sharding.Mesh`` / ``NamedSharding`` / ``PartitionSpec`` and of a
sharded ``jax.Array``.

  * ``Mesh``: logical device ids arranged in a named grid, plus a placement
    from logical id to ``torch.device``.  By default id ``i`` lives on
    ``cuda:(i % device_count)``: on one card every id maps to ``cuda:0``
    (each shard still its own buffer, a move a real device-to-device copy),
    on four cards id ``i`` to ``cuda:i``.  ``device="cpu"`` places every id
    on the host; it is only ever the caller's choice.
  * ``P``: a partition spec, one entry per leading dim: None (unsharded), a
    mesh axis name, or a tuple of names (sharded over their product,
    first name major).  Missing trailing entries are None.
  * ``Layout(mesh, spec)``: where each block of a tensor lives.  Two
    layouts are equivalent (``is_equivalent_to``) when they have the same
    placement, the same device list in mesh order (as JAX compares
    ``_internal_device_list``) and put the same block on every device,
    which is JAX's comparison of the two HLO shardings: a size-1 axis and a
    trailing None shard nothing.
  * ``ShardedTensor``: a global shape and dtype, a layout and one local
    block per logical device (copies where a dim is replicated, as JAX's
    addressable shards are).  ``place(full, layout)`` splits a tensor onto a
    layout, ``gather()`` joins the blocks back.  A sharded tensor donated to
    a reshard (``parallel/realloc_exec.py``) has released its blocks and
    raises on use, as a donated JAX array does.

Trees (parameters, specs, layouts) are nested dicts and lists; every other
value, a ``P`` included, is a leaf, and leaves are visited in the order of
``jax.tree.leaves`` (dict keys sorted).
"""

from __future__ import annotations

import itertools
import math
from typing import Callable, Optional, Union

import numpy as np
import torch


class P(tuple):
    """A partition spec: ``P("data", None)``, ``P(("data", "model"))``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}" if len(self) != 1 else f"P({self[0]!r})"


def axes_of(part) -> tuple:
    """The mesh axes of one spec entry."""
    if part is None:
        return ()
    return tuple(part) if isinstance(part, tuple) else (part,)


# ------------------------------------------------------------------- trees

def tree_leaves(tree) -> list:
    """The leaves of a nested dict/list tree (None is an empty subtree)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching subtrees of
    ``rest``.  A leaf of ``tree`` takes whatever sits at its place in each
    of them; where one of them has a leaf (or None) in place of a subtree,
    every leaf below takes that value."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] if isinstance(r, dict) else r for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] if isinstance(r, list) else r for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over the leaves; a path is a tuple of dict keys and
    list indices."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree)]
    return fn(path, tree)


def tree_at(tree, path):
    """The subtree (or leaf) of ``tree`` at ``path``, as
    ``tree_map_with_path`` gives paths."""
    for key in path:
        tree = tree[key]
    return tree


# -------------------------------------------------------------------- mesh

Placement = Union[None, str, torch.device, Callable[[int], torch.device]]


def _placement(device: Placement) -> Callable[[int], torch.device]:
    if callable(device) and not isinstance(device, (str, torch.device)):
        return device
    kind = torch.device(device if device is not None else "cuda").type
    if kind == "cpu":
        cpu = torch.device("cpu")
        return lambda i: cpu
    if kind != "cuda":
        raise ValueError(f"Mesh(device={device!r}): need 'cuda', 'cpu' or a callable")
    if not torch.cuda.is_available():
        raise RuntimeError("Mesh: no CUDA device is available; pass device='cpu' to lay "
                           "the mesh out on the host")
    n = torch.cuda.device_count()
    devs = [torch.device("cuda", j) for j in range(n)]
    return lambda i: devs[i % n]


class Mesh:
    """Logical device ids in a named grid (``devices`` has one dim per axis)
    and their placement on torch devices."""

    def __init__(self, devices, axis_names, *, device: Placement = None):
        arr = np.asarray(devices, dtype=np.int64)
        names = tuple(axis_names)
        if arr.ndim != len(names):
            raise ValueError(f"mesh of shape {arr.shape} needs {arr.ndim} axis names, "
                             f"got {names}")
        if len(set(names)) != len(names):
            raise ValueError(f"repeated mesh axis in {names}")
        self.devices = arr
        self.axis_names = names
        self.shape = dict(zip(names, arr.shape))
        self.device_ids = tuple(int(i) for i in arr.ravel())
        if len(set(self.device_ids)) != len(self.device_ids):
            raise ValueError(f"repeated device id in mesh {self.device_ids}")
        self.device_set = frozenset(self.device_ids)
        self._place = _placement(device)
        self._where = tuple(self._place(i) for i in self.device_ids)
        self._hash = hash(self._key())

    @property
    def size(self) -> int:
        return len(self.device_ids)

    def torch_device(self, i: int) -> torch.device:
        return self._where[self.device_ids.index(i)]

    def _key(self):
        return (self.devices.shape, self.device_ids, self.axis_names, self._where)

    def __eq__(self, other):
        return isinstance(other, Mesh) and self._key() == other._key()

    def __hash__(self):
        return self._hash

    def __repr__(self):
        return f"Mesh({self.devices.tolist()}, {self.axis_names})"


# ------------------------------------------------------------------ layout

Region = tuple  # ((start, stop), ...) per dim


class Layout:
    """A mesh and a partition spec (the counterpart of ``NamedSharding``)."""

    def __init__(self, mesh: Mesh, spec=P()):
        spec = P(*spec)
        used = [a for part in spec for a in axes_of(part)]
        unknown = [a for a in used if a not in mesh.shape]
        if unknown:
            raise ValueError(f"spec {spec} names axes {unknown} not in mesh {mesh.axis_names}")
        if len(set(used)) != len(used):
            raise ValueError(f"spec {spec} uses a mesh axis twice")
        self.mesh, self.spec = mesh, spec
        self._hash = hash((mesh, spec))
        self._memo: dict = {}  # (what, ndim or shape) -> grid or regions

    @property
    def device_set(self) -> frozenset:
        return self.mesh.device_set

    def _grid(self, ndim: int) -> list[tuple]:
        """Per logical device in mesh order: (index, count) of its shard
        along each of the ``ndim`` dims."""
        key = ("grid", ndim)
        if key not in self._memo:
            self._memo[key] = self._make_grid(ndim)
        return self._memo[key]

    def _make_grid(self, ndim: int) -> list[tuple]:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} is longer than the tensor's {ndim} dims")
        pos = {a: i for i, a in enumerate(self.mesh.axis_names)}
        out = []
        for coord in itertools.product(*(range(n) for n in self.mesh.devices.shape)):
            per_dim = []
            for d in range(ndim):
                axes = axes_of(self.spec[d]) if d < len(self.spec) else ()
                idx, k = 0, 1
                for a in axes:
                    idx = idx * self.mesh.shape[a] + coord[pos[a]]
                    k *= self.mesh.shape[a]
                per_dim.append((idx, k))
            out.append(tuple(per_dim))
        return out

    def regions(self, shape) -> list[tuple[int, Region]]:
        """(logical id, the block's (start, stop) per dim) for every device
        of the mesh, in mesh order; a dim that a count does not divide is
        cut in ceil-sized blocks, as JAX cuts it."""
        key = ("regions", tuple(shape))
        if key in self._memo:
            return self._memo[key]
        out = []
        for dev, grid in zip(self.mesh.device_ids, self._grid(len(shape))):
            reg = []
            for n, (idx, k) in zip(shape, grid):
                size = -(-n // k)
                reg.append((min(n, idx * size), min(n, (idx + 1) * size)))
            out.append((dev, tuple(reg)))
        self._memo[key] = out
        return out

    def is_equivalent_to(self, other: "Layout", ndim: int) -> bool:
        return (isinstance(other, Layout)
                and self.mesh._where == other.mesh._where
                and self.mesh.device_ids == other.mesh.device_ids
                and self._grid(ndim) == other._grid(ndim))

    def __eq__(self, other):
        return (isinstance(other, Layout) and self.mesh == other.mesh
                and self.spec == other.spec)

    def __hash__(self):
        return self._hash

    def __repr__(self):
        return f"Layout({self.mesh!r}, {self.spec!r})"


def slices(region: Region, origin: Optional[Region] = None) -> tuple:
    """``region`` as slices, relative to the start of ``origin``."""
    if origin is None:
        return tuple(slice(a, b) for a, b in region)
    return tuple(slice(a - o, b - o) for (a, b), (o, _) in zip(region, origin))


def intersect(a: Region, b: Region) -> Optional[Region]:
    out = tuple((max(x0, y0), min(x1, y1)) for (x0, x1), (y0, y1) in zip(a, b))
    return out if all(lo < hi for lo, hi in out) else None


def region_shape(region: Region) -> tuple:
    return tuple(b - a for a, b in region)


# ----------------------------------------------------------- sharded tensor

class ShardedTensor:
    """A tensor laid out on a ``Layout``: one local block per logical
    device.  ``shards`` lists (logical id, region, block) in mesh order."""

    def __init__(self, shape, dtype, layout: Layout, blocks: dict):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.layout = layout
        regs = layout.regions(self.shape)
        if set(blocks) != {d for d, _ in regs}:
            raise ValueError("one block per device of the layout's mesh is needed")
        for d, reg in regs:
            if tuple(blocks[d].shape) != region_shape(reg):
                raise ValueError(f"block of device {d} has shape {tuple(blocks[d].shape)}, "
                                 f"the layout gives {region_shape(reg)}")
        self._regions = dict(regs)
        self._blocks = dict(blocks)
        self.donated = False

    # ---------------------------------------------------------- properties
    @property
    def ndim(self) -> int:
        return len(self.shape)

    def numel(self) -> int:
        return math.prod(self.shape)

    @property
    def nbytes(self) -> int:
        """The global tensor's bytes (one copy, whatever the replication)."""
        return self.numel() * self.dtype.itemsize

    @property
    def blocks(self) -> dict:
        if self.donated:
            raise RuntimeError("this ShardedTensor was donated to a reshard; its blocks "
                               "are released")
        return self._blocks

    @property
    def shards(self) -> list:
        blocks = self.blocks
        return [(d, self._regions[d], blocks[d]) for d in self.layout.mesh.device_ids]

    def unique_shards(self) -> list:
        """One shard per distinct region (the first holder in mesh order):
        the regions tile the tensor once."""
        seen, out = set(), []
        for d, reg, blk in self.shards:
            if reg not in seen:
                seen.add(reg)
                out.append((d, reg, blk))
        return out

    def local_bytes(self) -> int:
        """Bytes held by all blocks, replicas counted each."""
        return sum(b.numel() * b.element_size() for b in self.blocks.values())

    def _release(self):
        self._blocks = {}
        self.donated = True

    # ---------------------------------------------------------- construction
    @classmethod
    def place(cls, full: torch.Tensor, layout: Layout) -> "ShardedTensor":
        """``full`` split onto ``layout``: every block a fresh buffer on its
        device (the counterpart of ``jax.device_put(x, sharding)``)."""
        full = full.detach()
        blocks = {}
        for d, reg in layout.regions(full.shape):
            b = torch.empty(region_shape(reg), dtype=full.dtype,
                            device=layout.mesh.torch_device(d))
            b.copy_(full[slices(reg)])
            blocks[d] = b
        return cls(full.shape, full.dtype, layout, blocks)

    def gather(self, device=None) -> torch.Tensor:
        """The global tensor, on ``device`` (default: the first block's)."""
        shards = self.unique_shards()
        device = torch.device(device) if device is not None else shards[0][2].device
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        for _, reg, blk in shards:
            out[slices(reg)].copy_(blk)
        return out

    def map_blocks(self, fn) -> "ShardedTensor":
        """``fn`` applied to every block (an elementwise op keeps the
        layout); the result is a new sharded tensor."""
        blocks = {d: fn(b) for d, b in self.blocks.items()}
        dtype = next(iter(blocks.values())).dtype
        return ShardedTensor(self.shape, dtype, self.layout, blocks)

    def __repr__(self):
        state = ", donated" if self.donated else ""
        return (f"ShardedTensor(shape={tuple(self.shape)}, dtype={self.dtype}, "
                f"{self.layout!r}{state})")


def place_tree(tree, layouts):
    """Every tensor leaf of ``tree`` placed on the layout at its place in
    ``layouts`` (a leaf with layout None, or no tensor, stays as it is)."""
    def one(x, lay):
        if lay is None or not isinstance(x, torch.Tensor):
            return x
        return ShardedTensor.place(x, lay)
    return tree_map(one, tree, layouts)
