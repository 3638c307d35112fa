"""Collectives over named axes of a ``Mesh`` of logical devices: the port's
counterpart of XLA's ``psum`` / ``pmax`` / ``all_gather`` /
``psum_scatter`` / ``all_to_all`` / ``ppermute``.

The port runs explicit SPMD in one process: every rank (logical device id)
holds its own value, and a per-rank value is a dict ``{logical id:
tensor}``.  A collective takes such a dict and returns one.  The members
of a group are the ranks that differ only in their coordinates along the
named axes (several axes: their product, first name major, as a ``P``
entry orders them), visited in that order.

Every collective is built from plain differentiable tensor ops (``cat``,
``+``, slicing) and ``move``, a counted copy between ranks, so autograd
carries gradients across ranks and cards with no process group: the
backward of ``all_gather`` is a reduce-scatter, that of ``all_reduce`` an
all-reduce (``grad_all_reduce`` is the identity whose backward alone is
an all-reduce).  An all-reduce sums once, in rank order on the group's first
member, and hands every other member a copy of that one result, so
replicas stay bit-equal.  A member's own value is never copied; a group of
one returns its value unchanged.

``STATS`` counts the bytes and copies that ``move`` made (forward and
backward), the traffic of this one-process emulation.  ``RECORD`` counts
the collectives themselves, as XLA's HLO lists them: one entry per call
(not per group), keyed by its kind (``launch/roofline.COLLECTIVES``' names),
its full payload in bytes (an all-gather's result, a reduce-scatter's
input, an all-reduce's or all-to-all's value), its group size and the
number of ``NODE_CARDS``-card nodes a group spans (ids ``i //
NODE_CARDS`` share a node).  A call made where autograd records also
tags its output, so its backward is recorded as the dual collective (an
all-gather's as a reduce-scatter, an all-reduce's as an all-reduce).
Groups of one are not recorded.  The roofline prices ``RECORD``, not
``STATS``, because this module's all-reduce gathers to one member where a
ring would not.
"""

from __future__ import annotations

import collections
import math

import numpy as np
import torch

STATS = {"bytes": 0, "copies": 0}
NODE_CARDS = 8  # cards per H100 node, joined by NVLink
RECORD: collections.Counter = collections.Counter()  # (kind, bytes, k, nodes) -> calls

_DUAL = {"all-gather": "reduce-scatter", "reduce-scatter": "all-gather",
         "all-reduce": "all-reduce", "all-to-all": "all-to-all",
         "collective-permute": "collective-permute"}


def reset_stats():
    STATS.update(bytes=0, copies=0)
    RECORD.clear()


def _key(kind: str, nbytes: int, gs) -> tuple:
    return (kind, int(nbytes), len(gs[0]),
            max(len({i // NODE_CARDS for i in g}) for g in gs))


class _Tag(torch.autograd.Function):
    """The identity; its backward records the call's dual collective."""

    @staticmethod
    def forward(ctx, x, key):
        ctx.key = key
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        RECORD[ctx.key] += 1
        return g, None


def _record(out: dict, kind: str, nbytes: int, gs, backward=True) -> dict:
    """Count one call of ``kind`` over the groups ``gs``; tag one member's
    output so that its backward counts the dual call."""
    if len(gs[0]) < 2:
        return out
    RECORD[_key(kind, nbytes, gs)] += 1
    first = gs[0][0]
    if backward and first in out and out[first].requires_grad:
        out = dict(out)
        out[first] = _Tag.apply(out[first], _key(_DUAL[kind], nbytes, gs))
    return out


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


class _Move(torch.autograd.Function):
    """A copy of ``x`` onto ``device`` (a fresh buffer even on the same
    card); its backward copies the gradient back.  Both directions count
    in ``STATS``."""

    @staticmethod
    def forward(ctx, x, device):
        ctx.src = x.device
        STATS["bytes"] += x.numel() * x.element_size()
        STATS["copies"] += 1
        return x.to(device, copy=True)

    @staticmethod
    def backward(ctx, g):
        STATS["bytes"] += g.numel() * g.element_size()
        STATS["copies"] += 1
        return g.to(ctx.src, copy=True), None


def move(x: torch.Tensor, device) -> torch.Tensor:
    """``x`` copied to ``device`` as one rank sends it to another."""
    return _Move.apply(x, torch.device(device))


def _axes(axis) -> tuple:
    return (axis,) if isinstance(axis, str) else tuple(axis)


def groups(mesh, axis) -> list[list[int]]:
    """The groups of ``axis`` (a name or a tuple of names): lists of
    logical ids, each ordered by the ids' index along the axes."""
    axes = _axes(axis)
    pos = [mesh.axis_names.index(a) for a in axes]
    rest = [i for i in range(len(mesh.axis_names)) if i not in pos]
    k = math.prod(mesh.shape[a] for a in axes)
    arr = np.transpose(mesh.devices, rest + pos).reshape(-1, k)
    return [[int(i) for i in row] for row in arr]


def axis_index(mesh, axis, rank: int) -> int:
    """``rank``'s index within its group of ``axis``."""
    for g in groups(mesh, axis):
        if rank in g:
            return g.index(rank)
    raise ValueError(f"logical device {rank} is not in mesh {mesh!r}")


def axis_size(mesh, axis) -> int:
    return math.prod(mesh.shape[a] for a in _axes(axis))


def all_reduce(xs: dict, mesh, axis, *, op: str = "sum") -> dict:
    """Sum (or max, ``op="max"``) over the group, in rank order, on the
    group's first member; every other member gets a copy."""
    if op not in ("sum", "max"):
        raise ValueError(f"all_reduce: op={op!r}; need 'sum' or 'max'")
    out = {}
    gs = groups(mesh, axis)
    for g in gs:
        root = xs[g[0]]
        if len(g) == 1:
            out[g[0]] = root
            continue
        total = root
        for r in g[1:]:
            y = move(xs[r], root.device)
            total = total + y if op == "sum" else torch.maximum(total, y)
        out[g[0]] = total
        for r in g[1:]:
            out[r] = move(total, xs[r].device)
    return _record(out, "all-reduce", _nbytes(xs[gs[0][0]]), gs, backward=op == "sum")


class _GradAllReduce(torch.autograd.Function):
    """The identity on every rank's value; the backward all-reduces the
    gradients (``all_reduce``, which records the call)."""

    @staticmethod
    def forward(ctx, mesh, axis, ranks, *xs):
        ctx.mesh, ctx.axis, ctx.ranks = mesh, axis, ranks
        ctx.like = [(x.shape, x.dtype, x.device) for x in xs]
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *gs):
        gs = {r: torch.zeros(shape, dtype=dtype, device=dev) if g is None else g
              for r, g, (shape, dtype, dev) in zip(ctx.ranks, gs, ctx.like)}
        out = all_reduce(gs, ctx.mesh, ctx.axis)
        return (None, None, None, *(out[r] for r in ctx.ranks))


def grad_all_reduce(xs: dict, mesh, axis) -> dict:
    """``xs`` as it is; its backward sums the gradient over the group, in
    rank order, and hands every member the sum (an all-reduce of the
    gradient's bytes, recorded when the backward runs)."""
    ranks = tuple(xs)
    return dict(zip(ranks, _GradAllReduce.apply(mesh, axis, ranks, *(xs[r] for r in ranks))))


def all_gather(xs: dict, mesh, axis, dim: int = 0) -> dict:
    """Every member gets the group's values concatenated along ``dim`` in
    rank order."""
    out = {}
    gs = groups(mesh, axis)
    for g in gs:
        for m in g:
            dev = xs[m].device
            parts = [xs[r] if r == m else move(xs[r], dev) for r in g]
            out[m] = parts[0] if len(parts) == 1 else torch.cat(parts, dim)
    return _record(out, "all-gather", _nbytes(out[gs[0][0]]), gs)


def reduce_scatter(xs: dict, mesh, axis, dim: int = 0) -> dict:
    """Member i gets the sum over the group, in rank order, of every
    member's i-th chunk along ``dim`` (which the group size must divide)."""
    out = {}
    gs = groups(mesh, axis)
    for g in gs:
        k = len(g)
        for i, m in enumerate(g):
            dev = xs[m].device
            total = None
            for r in g:
                if xs[r].shape[dim] % k:
                    raise ValueError(f"reduce_scatter: dim {dim} of {tuple(xs[r].shape)} "
                                     f"does not split into {k}")
                c = xs[r].chunk(k, dim)[i]
                c = c if r == m else move(c, dev)
                total = c if total is None else total + c
            out[m] = total
    return _record(out, "reduce-scatter", _nbytes(xs[gs[0][0]]), gs)


def all_to_all(xs: dict, mesh, axis, split_dim: int = 0, concat_dim: int = 0) -> dict:
    """Member i gets, concatenated along ``concat_dim`` in rank order, the
    i-th chunk along ``split_dim`` of every member's value."""
    out = {}
    gs = groups(mesh, axis)
    for g in gs:
        k = len(g)
        for i, m in enumerate(g):
            dev = xs[m].device
            parts = []
            for r in g:
                if xs[r].shape[split_dim] % k:
                    raise ValueError(f"all_to_all: dim {split_dim} of {tuple(xs[r].shape)} "
                                     f"does not split into {k}")
                c = xs[r].chunk(k, split_dim)[i]
                parts.append(c if r == m else move(c, dev))
            out[m] = torch.cat(parts, concat_dim)
    return _record(out, "all-to-all", _nbytes(xs[gs[0][0]]), gs)


def ppermute(xs: dict, mesh, axis, perm) -> dict:
    """``perm``: (source index, destination index) pairs along the axis.
    A destination gets its source's value; a member that is no destination
    gets zeros, as XLA's ``ppermute``.  Ranks missing from ``xs`` (idle
    pipeline stages) send nothing, and their destinations get no entry."""
    out = {}
    gs = groups(mesh, axis)
    for g in gs:
        for src, dst in perm:
            if g[src] in xs:
                x = xs[g[src]]
                out[g[dst]] = x if src == dst else move(x, mesh.torch_device(g[dst]))
        for r in g:
            if r not in out and r in xs:
                out[r] = torch.zeros_like(xs[r])
    if not xs:
        return out
    return _record(out, "collective-permute", _nbytes(next(iter(xs.values()))), gs)


def broadcast(xs: dict, mesh, axis, src: int) -> dict:
    """Every member of each group gets a copy of the value held by the
    member at index ``src`` (recorded as a collective-permute of it)."""
    out = {}
    gs = groups(mesh, axis)
    for g in gs:
        x = xs[g[src]]
        for r in g:
            out[r] = x if r == g[src] else move(x, mesh.torch_device(r))
    return _record(out, "collective-permute", _nbytes(xs[gs[0][src]]), gs, backward=False)


def lse_merge(outs: dict, lses: dict, mesh, axis) -> dict:
    """Attention partials merged over ``axis``: outs {rank: (..., D) fp32,
    the rank's softmax-normalised output over its keys}, lses {rank: (...)
    fp32, the log-sum-exp of its scaled logits, -inf where it has no key}.
    An all-reduce max of the lse, then one all-reduce sum, in rank order, of
    [exp(lse - max) out, exp(lse - max)], then the division: fp32 throughout,
    so the caller casts the merged row once.  Both calls are recorded in
    ``RECORD``.  Every row must have a key on some member (the max is then
    finite)."""
    top = all_reduce(lses, mesh, axis, op="max")
    parts = {}
    for r, out in outs.items():
        w = torch.exp(lses[r] - top[r])[..., None]
        parts[r] = torch.cat([out * w, w], dim=-1)
    total = all_reduce(parts, mesh, axis)
    return {r: x[..., :-1] / x[..., -1:] for r, x in total.items()}
