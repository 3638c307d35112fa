"""Turn the JAX package's parameter tree, given as numpy arrays, into the
port's parameters.

The JAX tree keeps each layer group's parameters stacked on a leading
layer axis (``groups[g]["b{i}"]``, scanned over); the port keeps one dict
per layer, in the order the config's ``layers`` lists them.  A bf16 leaf
arrives as an ``ml_dtypes.bfloat16`` numpy array, which ``torch.from_numpy``
rejects: its 16-bit pattern is reinterpreted instead (exact).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import check_supported


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    return fn(tree)


def _layers(np_groups, cfg: ModelConfig, device):
    """The JAX package's stacked groups as the port's list of layer dicts."""
    groups = [(cfg.superblock, cfg.n_superblocks)]
    if cfg.tail:
        groups.append((cfg.tail, 1))
    if len(np_groups) != len(groups):
        raise ValueError(f"{cfg.name}: tree has {len(np_groups)} groups, "
                         f"config {len(groups)}")
    layers = []
    for (specs, n), group in zip(groups, np_groups):
        for r in range(n):
            for i in range(len(specs)):
                layers.append(_map(lambda a: _tensor(np.asarray(a)[r], device),
                                   group[f"b{i}"]))
    return layers


def params_from_jax(np_tree, cfg: ModelConfig, device="cuda"):
    """np_tree: the JAX ``init_params`` tree with numpy leaves (nested dicts;
    ``groups`` a list).  Returns the port's parameter dict on ``device``
    (an encoder-decoder's ``encoder`` subtree too, its ``groups`` as
    ``layers``)."""
    check_supported(cfg)
    out = {"embed": _map(lambda a: _tensor(a, device), np_tree["embed"]),
           "layers": _layers(np_tree["groups"], cfg, device),
           "final_norm": _map(lambda a: _tensor(a, device), np_tree["final_norm"])}
    for head in ("lm_head", "value_head"):
        if head in np_tree:
            out[head] = _map(lambda a: _tensor(a, device), np_tree[head])
    if "encoder" in np_tree:
        enc = np_tree["encoder"]
        out["encoder"] = {"layers": _layers(enc["groups"], cfg, device),
                          "final_norm": _map(lambda a: _tensor(a, device), enc["final_norm"])}
    return out
