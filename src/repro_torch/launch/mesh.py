"""Production mesh definitions.

Single pod: 16×16 = 256 devices, axes ("data", "model").
Multi-pod:  2×16×16 = 512 devices, axes ("pod", "data", "model") — the
"pod" axis is pure DP; gradient all-reduce over it is the cross-pod
traffic (and the target of the int8 error-feedback compression in
distributed/compression.py).

Functions, not module constants: importing this module touches no
device.  The meshes are ``FleetMesh``es of CUDA cards; specs resolve
against them (``distributed/sharding.py``), and one process drives one
card (more is ROADMAP item 9(c)).  With ``device="meta"`` a production
mesh is the one the dry run traces on (``launch/dryrun.py``): every
entry the meta device, the port's counterpart of the JAX package's
forced host devices.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._device import resolve_device
from ..distributed.sharding import FleetMesh

__all__ = ["make_production_mesh", "make_host_mesh"]


def make_production_mesh(*, multi_pod: bool = False,
                         device=None) -> FleetMesh:
    """(16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data",
    "model"), over the first 256 or 512 CUDA cards; raises ValueError,
    as ``jax.make_mesh`` does, when fewer are present.  ``device="meta"``
    gives the same mesh with the meta device at every entry, which needs
    no card."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if device is not None and torch.device(device).type == "meta":
        devs = np.empty(n, dtype=object)
        devs[:] = [torch.device("meta")] * n
        return FleetMesh(devs.reshape(shape), axes)
    have = torch.cuda.device_count()
    if have < n:
        raise ValueError(f"a {shape} mesh needs {n} devices, "
                         f"{have} CUDA devices present")
    devs = np.empty(n, dtype=object)
    devs[:] = [torch.device("cuda", i) for i in range(n)]
    return FleetMesh(devs.reshape(shape), axes)


def make_host_mesh(device=None) -> FleetMesh:
    """Degenerate 1×1 ("data", "model") mesh over the one device this
    process drives: the current CUDA card unless ``device`` says
    otherwise (``device="cpu"`` in tests)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return FleetMesh([[dev]], ("data", "model"))
