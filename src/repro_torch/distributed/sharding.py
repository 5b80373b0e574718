"""Device meshes for the fleet layer.

``FleetMesh`` is the port's mesh: an array of ``torch.device`` entries
with one axis name per array dimension.  Used as a context manager it
pushes itself on a module-level stack, and ``active_mesh()`` returns the
innermost one — the counterpart of the JAX package's ``with Mesh(...)``
context, without a process group.  The fleet layer
(``distributed/fleet.py``) reads it to shard the instance axis.

The logical-axis sharding rules of the JAX package's model code are not
part of the port yet (training needs them).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["FleetMesh", "active_mesh"]

_ACTIVE: list = []


class FleetMesh:
    """An n-D array of devices with one name per axis.

    ``devices`` is a numpy object array of ``torch.device``; the same
    device may appear more than once (several shards on one host device,
    the port's counterpart of the JAX package's forced host devices).
    """

    def __init__(self, devices, axis_names):
        arr = np.empty(np.shape(np.asarray(devices, dtype=object)),
                       dtype=object)
        flat = np.asarray(devices, dtype=object).reshape(-1)
        arr.reshape(-1)[:] = [torch.device(d) for d in flat]
        self.devices = arr
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != arr.ndim:
            raise ValueError(f"{arr.ndim}-D devices need {arr.ndim} axis "
                             f"names, got {self.axis_names}")
        if arr.size == 0:
            raise ValueError("a mesh needs at least one device")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __enter__(self):
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc):
        _ACTIVE.remove(self)
        return False

    def __repr__(self):
        return (f"FleetMesh({self.shape}, "
                f"devices={[str(d) for d in self.devices.flat]})")


def active_mesh():
    """The mesh of the innermost active ``with FleetMesh(...)``, or None."""
    return _ACTIVE[-1] if _ACTIVE else None
