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
once, not once per replica.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.parallel.layout import ShardedTensor

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


def init(cfg: AdamWConfig, params):
    """Optimizer state of ``params``: step 0, m and v zeros in
    ``state_dtype``, the master copy in ``master_dtype`` (a copy even where
    the parameter already has that dtype)."""
    sd, md = DTYPES[cfg.state_dtype], DTYPES[cfg.master_dtype]
    with torch.no_grad():
        return {"step": 0,
                "m": _map(lambda p: torch.zeros(p.shape, dtype=sd, device=p.device), params),
                "v": _map(lambda p: torch.zeros(p.shape, dtype=sd, device=p.device), params),
                "master": _map(lambda p: p.detach().to(md, copy=True), params)}


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
    itself, or per logical device of a ``ShardedTensor`` its blocks (every
    member of the tuple on the same layout)."""
    if not isinstance(leaf[0], ShardedTensor):
        return [leaf]
    lay = leaf[0].layout
    if any(x.layout != lay for x in leaf):
        raise ValueError(f"AdamW on sharded leaves needs the state and gradient on the "
                         f"parameter's layout {lay!r}")
    return [tuple(x.blocks[d] for x in leaf) for d in lay.mesh.device_ids]


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
