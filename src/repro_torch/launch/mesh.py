"""Mesh construction, the port's copy of the JAX package's
``launch/mesh.py``.  A mesh here is logical (``parallel/layout.Mesh``): ids
``0 .. n-1`` placed on the cards (``cuda:(i % device_count)``) unless the
caller asks for the host.  The TPU pod's ``make_production_mesh`` (2 x 16 x
16 devices) has no counterpart yet.
"""

from __future__ import annotations

import numpy as np

from repro_torch.parallel.layout import Mesh


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
