"""Mesh construction, the port's copy of the JAX package's
``launch/mesh.py``.  A mesh here is logical (``parallel/layout.Mesh``): ids
``0 .. n-1`` placed on the cards (``cuda:(i % device_count)``) unless the
caller asks for the host.  ``make_production_mesh`` is the H100-cluster
counterpart of the TPU pods' 256- and 512-device meshes, for the dry run
(``launch/dryrun.py``) on ``meta`` tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.parallel.layout import Mesh


def make_production_mesh(multi_pod: bool = False, *, device=None) -> Mesh:
    """The JAX package's production mesh on H100s: (16, 16) ("data",
    "model") over 256 cards, or with ``multi_pod`` (2, 16, 16) ("pod",
    "data", "model") over 512: 32 or 64 nodes of ``collectives.NODE_CARDS`` (8) cards.
    Ids are node-major with the model axis innermost, as the JAX mesh
    orders them: id i lies on node i // 8, so a 16-wide model group spans
    two NVLink nodes (its all-reduces cross the nodes' network, not
    NVLink alone) and a data or pod group spans 16 or 32 nodes.

    ``device``: None or "meta" places every id on the ``meta`` device
    (shapes without data, for the dry run); a callable maps an id to its
    ``torch.device``.  Anything else raises: 256 or 512 ids never land on
    one card unasked."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    if device is None or (isinstance(device, (str, torch.device))
                          and torch.device(device).type == "meta"):
        meta = torch.device("meta")
        place = lambda i: meta  # noqa: E731
    elif callable(device) and not isinstance(device, (str, torch.device)):
        place = device
    else:
        raise ValueError(f"make_production_mesh(device={device!r}): {int(np.prod(shape))} "
                         "ids need 'meta' or a callable id -> torch.device")
    return Mesh(np.arange(int(np.prod(shape))).reshape(shape), axes, device=place)


def make_test_mesh(n_devices: int, axes=("data", "model"), *, device=None) -> Mesh:
    """A small mesh over ``n_devices`` logical devices: two axes as the most
    square (data, model) split with data <= model, or one axis."""
    n = n_devices
    if len(axes) == 2:
        d = 1
        for cand in range(int(n ** 0.5), 0, -1):
            if n % cand == 0:
                d = cand
                break
        shape = (n // d, d)
    else:
        shape = (n,)
    return Mesh(np.arange(n).reshape(shape), axes, device=device)


def submesh(devices, shape, axis_names, *, device=None) -> Mesh:
    """A mesh over an explicit subset of logical devices (realises a ReaL
    ``DeviceMesh`` + ``ParallelStrategy`` as a mesh for one call)."""
    return Mesh(np.asarray(devices).reshape(shape), axis_names, device=device)
