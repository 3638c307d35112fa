"""Sharding rules: parameter tree -> spec tree for a strategy, the port's copy
of the JAX package's ``parallel/sharding.py``.

Logical placement:
  * TP  ("model" axis): attention q/kv projections (fused head dim), MLP ffn
    dim, vocab dim, MoE expert axis (EP), SSM/LRU inner dims.
  * FSDP ("data" axis, optional): the non-TP matrix dim of every large param,
    ZeRO-3 style.
  * "pod" axis (multi-pod): pure data parallelism for activations; optionally
    folded into FSDP for optimizer-state sharding (ZeRO-1 across pods).

Sharding the *fused* q/kv/ffn dims (not head counts) sidesteps divisibility
issues (56 heads on a 16-way axis shards as 7168 columns -> 448/device).

The port keeps one dict per layer (``params["layers"][i]``) where the JAX
package stacks each layer group on a leading dim (``groups[g]["b{i}"]``), so
a port leaf's spec is the JAX leaf's with the stack dim dropped; the rules
below keep the JAX file's ``"groups"`` branch for trees that do stack.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.parallel.layout import Layout, Mesh, P, tree_map, tree_map_with_path


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    tp_axis: Optional[str] = "model"
    fsdp_axis: Optional[str] = "data"  # None disables FSDP (pure DP replicas)
    dp_axes: tuple = ("data",)         # batch dims of activations
    pod_axis: Optional[str] = None     # extra leading DP axis across pods
    shard_opt_over_pod: bool = True    # ZeRO-1 over the pod axis

    @property
    def batch_axes(self):
        return ((self.pod_axis,) if self.pod_axis else ()) + tuple(self.dp_axes)


# weight-name -> spec.  t = tp axis, f = fsdp axis.
def _matrix_rules(t, f):
    return {
        # attention
        "wq": P(f, t), "wk": P(f, t), "wv": P(f, t), "wo": P(t, f),
        # dense mlp
        "w_gate": P(f, t), "w_in": P(f, t), "w_out": P(t, f),
        # ssm / lru
        "in_proj": P(f, t), "out_proj": P(t, f),
        # heads
        "lm_head": P(f, t), "value_head": P(None, None),
        "router": P(f, None),
    }


def _path_names(path) -> list[str]:
    return [f"[{k}]" if isinstance(k, int) else str(k) for k in path]


def param_spec(path, leaf, rules: ShardingRules) -> P:
    """The spec of one parameter leaf from its tree path (dict keys and list
    indices)."""
    t, f = rules.tp_axis, rules.fsdp_axis
    names = _path_names(path)
    stacked = "groups" in names  # leading scan-stack dim => first axis None
    mat = _matrix_rules(t, f)
    ndim = leaf.ndim

    def with_stack(spec: P) -> P:
        want = len(spec) + (1 if stacked else 0)
        if ndim != want:  # bias / vector param alongside a matrix rule
            return P(*([None] * (ndim - 1) + [spec[-1]]))
        return P(*(((None,) + tuple(spec)) if stacked else tuple(spec)))

    # embedding table: vocab x embed
    if names[-2:] == ["embed", "table"] or names[-1] == "table":
        return P(t, f)
    # MoE experts: (E, D, F) / (E, F, D) — expert axis gets TP (=EP)
    for key in ("w_gate", "w_in", "w_out"):
        if key in names and ndim - (1 if stacked else 0) == 3:
            inner = P(t, f, None) if key != "w_out" else P(t, None, f)
            return P(*(((None,) + tuple(inner)) if stacked else tuple(inner)))
    for key, spec in mat.items():
        if key in names and names[-1] == "w":
            return with_stack(spec)
        if key in names and names[-1] == "b":
            return with_stack(P(spec[-1]))
    # conv weights (K, CH): shard channels on TP
    if names[-1] in ("conv_w",):
        return with_stack(P(None, t))
    if names[-1] in ("conv_b", "gate_a_w", "gate_a_b", "gate_x_w",
                     "gate_x_b", "lam"):
        return with_stack(P(t))
    # per-head ssm vectors, norms, scalars: replicate
    return P(*([None] * ndim))


def param_specs(params, rules: ShardingRules):
    return tree_map_with_path(lambda path, leaf: param_spec(path, leaf, rules), params)


def sanitize_specs(spec_tree, shape_tree, mesh: Mesh):
    """Drop mesh axes from dims they don't divide.  Handles odd vocab sizes
    like 50280 / 49155 / 256206 on 16-way axes."""

    def fix(spec: P, leaf) -> P:
        shape = leaf.shape
        parts = []
        for i in range(len(shape)):
            p = spec[i] if i < len(spec) else None
            if p is None:
                parts.append(None)
                continue
            axes = p if isinstance(p, tuple) else (p,)
            k = 1
            for a in axes:
                k *= mesh.shape[a]
            parts.append(p if shape[i] % k == 0 else None)
        return P(*parts)

    return tree_map(fix, spec_tree, shape_tree)


def param_shardings(mesh: Mesh, params, rules: ShardingRules):
    """The layout tree of ``params`` on ``mesh``."""
    return tree_map(lambda s: Layout(mesh, s), param_specs(params, rules))


def batch_specs(batch, rules: ShardingRules):
    """Shard every batch leaf along its leading (batch) dim."""
    ax = tuple(a for a in rules.batch_axes if a)
    spec = ax if len(ax) > 1 else (ax[0] if ax else None)
    return tree_map(lambda x: P(spec, *([None] * (x.ndim - 1))), batch)


def opt_state_specs(param_specs_tree, rules: ShardingRules,
                    params_shapes=None, pod_size: int = 2):
    """Optimizer state sharding mirrors params; optionally ZeRO-1 over pod
    (shard the first unsharded, divisible dim of every state tensor)."""

    def widen(spec: P, shape=None) -> P:
        if not rules.pod_axis or not rules.shard_opt_over_pod:
            return spec
        parts = list(spec)
        for i, p in enumerate(parts):
            ok = shape is None or (i < len(shape)
                                   and shape[i] % pod_size == 0)
            if p is None and ok:
                parts[i] = rules.pod_axis
                return P(*parts)
        return spec

    if params_shapes is not None:
        mirrored = tree_map(lambda s, leaf: widen(s, leaf.shape), param_specs_tree,
                            params_shapes)
    else:
        mirrored = tree_map(widen, param_specs_tree)
    return {
        "step": P(),
        "m": mirrored,
        "v": mirrored,
        "master": mirrored,
    }
