"""AdamW with a mixed-precision state policy and global-norm clipping, as
the JAX package's ``optim/adamw.py``.

State: an fp32 master copy of the parameters and m/v in ``state_dtype``
(fp32 by default; bf16 halves the optimizer's memory).  Unlike the JAX
package's pure function, ``update`` writes the new parameters and state in
place, under ``torch.no_grad()``, so a step holds no second copy of either;
the values are the JAX package's.  Parameter trees are nested dicts and
lists of tensors, walked in a fixed order by :func:`leaves`.

A tree of ``ShardedTensor`` leaves (``parallel/steps.py``'s sharded step)
updates block by block: the state mirrors each parameter's layout, every
replica of a block computes the same update from the same values (so
replicas stay bit-equal), and ``global_norm`` counts each region of a leaf
once, not once per replica.  With ZeRO-1 (``init(layouts=...)`` from
``sharding.opt_state_specs(..., shard_opt_over_pod=True)``) a leaf's m, v
and master are further split over one more axis (the pod axis, or the
data axis of the dry run's ``dp_zero1``) along a dim the parameter keeps
whole: each rank updates its slice of the parameter block from the same
slice of the summed gradient, then the updated slices are all-gathered
over that axis into every replica's block, so the values are the
equal-layout update's bits.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.parallel import collectives as C
from repro_torch.parallel.layout import ShardedTensor, axes_of, slices, tree_map

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-5
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    state_dtype: str = "float32"  # m/v dtype; "bfloat16" halves opt memory
    master_dtype: str = "float32"


def leaves(tree) -> list:
    """The tensors of a nested dict/list tree, in a fixed order (dict keys
    sorted, as ``jax.tree.leaves`` orders them)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def _map(fn, tree):
    """``fn`` over the tensors of ``tree``; a ``ShardedTensor`` leaf maps
    block by block, keeping its layout."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(fn, v) for v in tree]
    if isinstance(tree, ShardedTensor):
        return tree.map_blocks(fn)
    return fn(tree)


def init(cfg: AdamWConfig, params, layouts=None):
    """Optimizer state of ``params``: step 0, m and v zeros in
    ``state_dtype``, the master copy in ``master_dtype`` (a copy even where
    the parameter already has that dtype).  ``layouts``: a tree like the
    ``ShardedTensor`` params of the ``Layout`` their m, v and master take
    (ZeRO-1: ``zero1_dim``'s one extra axis; a leaf's own layout keeps the
    state on it)."""
    sd, md = DTYPES[cfg.state_dtype], DTYPES[cfg.master_dtype]
    with torch.no_grad():
        if layouts is not None:
            params = tree_map(_state_view, params, layouts)
        return {"step": 0,
                "m": _map(lambda p: torch.zeros(p.shape, dtype=sd, device=p.device), params),
                "v": _map(lambda p: torch.zeros(p.shape, dtype=sd, device=p.device), params),
                "master": _map(lambda p: p.detach().to(md, copy=True), params)}


def zero1_dim(param_layout, state_layout):
    """(dim, axis) where ``state_layout`` splits a leaf over one more mesh
    axis than ``param_layout`` (ZeRO-1), None where the two are equal;
    any other difference raises."""
    if state_layout == param_layout:
        return None
    a, b = param_layout.spec, state_layout.spec
    n = max(len(a), len(b))
    a, b = (tuple(s) + (None,) * (n - len(s)) for s in (a, b))
    diff = [d for d in range(n) if a[d] != b[d]]
    if (state_layout.mesh == param_layout.mesh and len(diff) == 1 and a[diff[0]] is None
            and len(axes_of(b[diff[0]])) == 1):
        return diff[0], b[diff[0]]
    raise ValueError(f"AdamW on sharded leaves needs the state on the parameter's layout "
                     f"{param_layout!r} or split over one more axis of a dim it keeps whole; "
                     f"got {state_layout!r}")


def _cuts(st: ShardedTensor, layout) -> dict:
    """{rank: the slices of its block of ``st`` that its block on
    ``layout`` (a ZeRO-1 state layout) covers}."""
    regs, sregs = dict(st.layout.regions(st.shape)), dict(layout.regions(st.shape))
    return {d: slices(sregs[d], regs[d]) for d in regs}


def _state_view(st, layout):
    """``st`` (a ``ShardedTensor``) cut onto ``layout``: each rank's block
    the slice of its parameter block that the state layout gives it."""
    if layout is None or not isinstance(st, ShardedTensor) or zero1_dim(st.layout, layout) is None:
        return st
    cuts = _cuts(st, layout)
    return ShardedTensor(st.shape, st.dtype, layout,
                         {d: blk[cuts[d]] for d, blk in st.blocks.items()})


def _regions(g) -> list:
    """The tensors that tile a leaf once: the leaf, or one block per
    region of a ``ShardedTensor``."""
    if isinstance(g, ShardedTensor):
        return [blk for _, _, blk in g.unique_shards()]
    return [g]


def global_norm(grads) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32 (a sharded leaf's
    replicas counted once), on the first leaf's device."""
    terms = [torch.sum(torch.square(t.to(torch.float32)))
             for g in leaves(grads) for t in _regions(g)]
    dev = terms[0].device
    return torch.sqrt(sum(t.to(dev) for t in terms))


def _blocks(leaf) -> list:
    """One leaf's (param, m, v, grad, master) as aligned tensors: the leaf
    itself, or per logical device of a ``ShardedTensor`` its blocks (the
    gradient on the parameter's layout, the state on it too or split over
    one more axis, ``zero1_dim``; then the param and grad entries are the
    slices of their blocks that the state's block covers)."""
    if not isinstance(leaf[0], ShardedTensor):
        return [leaf]
    p, m, v, g, master = leaf
    lay, slay = p.layout, m.layout
    if g.layout != lay or v.layout != slay or master.layout != slay:
        raise ValueError(f"AdamW on sharded leaves needs the gradient on the parameter's "
                         f"layout {lay!r} and m, v, master on one layout")
    if zero1_dim(lay, slay) is None:
        return [tuple(x.blocks[d] for x in leaf) for d in lay.mesh.device_ids]
    cuts = _cuts(p, slay)
    return [(p.blocks[d][cuts[d]], m.blocks[d], v.blocks[d], g.blocks[d][cuts[d]],
             master.blocks[d]) for d in lay.mesh.device_ids]


def _gather_zero1(p: ShardedTensor, slay) -> None:
    """Every replica's parameter block rebuilt in place from the updated
    slices of its group over the ZeRO-1 axis (an all-gather over it)."""
    dim, axis = zero1_dim(p.layout, slay)
    cuts = _cuts(p, slay)
    whole = C.all_gather({d: blk[cuts[d]] for d, blk in p.blocks.items()}, p.layout.mesh,
                         axis, dim)
    for d, blk in p.blocks.items():
        blk.copy_(whole[d])


@torch.no_grad()
def update(cfg: AdamWConfig, params, state, grads, lr_scale=None):
    """One AdamW step; ``grads`` is a tree like ``params`` or the list of
    its leaves.  Writes the parameters and ``state`` in place and returns
    (params, state, stats) with stats {"grad_norm", "lr"}."""
    gl = leaves(grads)
    gnorm = global_norm(gl)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0)
    state["step"] += 1
    t = float(state["step"])
    bc1, bc2 = 1.0 - cfg.b1 ** t, 1.0 - cfg.b2 ** t
    lr = cfg.lr * (lr_scale if lr_scale is not None else 1.0)
    for leaf in zip(leaves(params), leaves(state["m"]), leaves(state["v"]), gl,
                    leaves(state["master"]), strict=True):
        zero1 = (isinstance(leaf[0], ShardedTensor)
                 and zero1_dim(leaf[0].layout, leaf[1].layout) is not None)
        for p, m, v, g, master in (x for b in _blocks(leaf) for x in _pieces(b)):
            g = g.to(torch.float32) * scale.to(g.device)
            m32 = m.to(torch.float32) * cfg.b1 + g * (1 - cfg.b1)
            v32 = v.to(torch.float32) * cfg.b2 + torch.square(g) * (1 - cfg.b2)
            master32 = master.to(torch.float32)
            delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps) + cfg.weight_decay * master32
            new_master = master32 - lr * delta
            p.copy_(new_master)
            m.copy_(m32)
            v.copy_(v32)
            master.copy_(new_master)
        if zero1:
            _gather_zero1(leaf[0], leaf[1].layout)
    return params, state, {"grad_norm": gnorm, "lr": torch.tensor(lr)}


# Elements per piece of a leaf's update: the update is elementwise, so it
# runs piece by piece with the same values, and its fp32 temporaries stay
# at about seven times 64 MiB however large the leaf (recurrentgemma-9b's
# tied embedding has 1.05e9 elements, 4.2 GB per fp32 temporary).
PIECE = 1 << 24


def _pieces(tensors):
    """One leaf's (param, m, v, grad, master) as aligned pieces of about
    PIECE elements: views of slices along the first axis, so in-place
    writes land in the leaf whatever its strides (a tied embedding's
    gradient comes transposed)."""
    t = tensors[0]
    if t.numel() <= PIECE:
        return [tensors]
    rows = max(1, PIECE * t.shape[0] // t.numel())
    return zip(*(x.split(rows) for x in tensors))
