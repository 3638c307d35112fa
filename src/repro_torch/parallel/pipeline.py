"""Pipeline parallelism: the JAX package's GPipe microbatch pipeline over a
``stage`` mesh axis, on the port's logical devices.

Layer params are stacked with a leading stage dim and laid out over the
stage axis (``P(stage_axis)``); stage s runs its layers while microbatch
activations move from stage to stage by ``ppermute``.  ``mbs + pp - 1``
ticks: at tick t stage s works on microbatch t - s when there is one (JAX
runs an idle stage on a dummy buffer and discards it; the port skips it).
The steady-state utilization is mbs / (mbs + pp - 1), the estimator's
bubble term.  Stages run one after another on the host; each stage's
layers run on its own logical device (on one card all stages share it).
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.parallel import collectives as C
from repro_torch.parallel.layout import (Layout, P, ShardedTensor, tree_leaves, tree_map,
                                         tree_map_with_path)


def pipeline_apply(layer_fn: Callable, stacked_params, x_micro, *, mesh,
                   stage_axis: str = "stage"):
    """Run a microbatched GPipe forward.

    ``layer_fn(params_for_stage, x) -> x``; ``stacked_params`` leaves have a
    leading dim of n_stages: ``ShardedTensor``s laid out ``P(stage_axis)``
    or tensors (placed so here).  ``x_micro``: (mbs, B_mb, ...) microbatched
    input.  Returns the (mbs, B_mb, ...) outputs of the last stage, handed
    to every stage: a ``ShardedTensor`` replicated over the mesh."""
    if set(mesh.axis_names) != {stage_axis}:
        raise ValueError(f"pipeline_apply runs on a mesh of the one axis {stage_axis!r}; got "
                         f"{mesh.axis_names}")
    pp = mesh.shape[stage_axis]
    mbs = x_micro.shape[0]
    if mbs < pp:
        raise ValueError(f"need >= {pp} microbatches to fill the pipeline; got {mbs}")
    stages = C.groups(mesh, stage_axis)[0]
    lay = Layout(mesh, P(stage_axis))

    def laid_out(a):
        st = a if isinstance(a, ShardedTensor) else ShardedTensor.place(a, lay)
        if st.shape[0] != pp or not st.layout.is_equivalent_to(lay, st.ndim):
            raise ValueError(f"a stacked leaf {st!r} is not laid out over the {pp} stages")
        return st
    sts = tree_map(laid_out, stacked_params)
    params = [tree_map(lambda st, r=r: st.blocks[r][0], sts) for r in stages]  # stage's layers
    buf, outputs = {}, [None] * mbs
    for t in range(mbs + pp - 1):
        ys = {}
        for s, r in enumerate(stages):
            m = t - s
            if not 0 <= m < mbs:
                continue
            x_in = C.move(x_micro[m], mesh.torch_device(r)) if s == 0 else buf[r]
            ys[r] = layer_fn(params[s], x_in)
        if stages[-1] in ys:
            outputs[t - (pp - 1)] = ys[stages[-1]]
        # rotate: stage s -> s + 1 (the last stage's output is collected)
        buf = C.ppermute({r: y for r, y in ys.items() if r != stages[-1]}, mesh, stage_axis,
                         [(i, i + 1) for i in range(pp - 1)])
    out = C.broadcast({stages[-1]: torch.stack(outputs)}, mesh, stage_axis, pp - 1)
    full = out[stages[-1]]
    return ShardedTensor(full.shape, full.dtype, Layout(mesh, P()), out)


def microbatch(x, mbs: int):
    b = x.shape[0]
    if b % mbs:
        raise ValueError(f"batch of {b} rows does not split into {mbs} microbatches")
    return x.reshape(mbs, b // mbs, *x.shape[1:])


def stack_stages(layers: list, pp: int):
    """A list of per-layer parameter trees of one structure as one tree
    whose leaves are (pp, len(layers) / pp, ...): stage s holds layers
    s * L / pp onwards, as the JAX package stacks them."""
    n = len(layers)
    if n % pp:
        raise ValueError(f"{n} layers do not split into {pp} stages")

    def get(tree, path):
        for k in path:
            tree = tree[k]
        return tree

    def stack(path, first):
        return torch.stack([get(p, path) for p in layers]).reshape(pp, n // pp, *first.shape)
    return tree_map_with_path(stack, layers[0])


def unstack_layers(stage_params) -> list:
    """One stage's (L / pp, ...) leaves as a list of per-layer trees (views),
    the form ``transformer.stack_apply`` takes."""
    n = tree_leaves(stage_params)[0].shape[0]
    return [tree_map(lambda a, i=i: a[i], stage_params) for i in range(n)]
