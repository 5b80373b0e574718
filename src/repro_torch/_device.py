"""Device and dtype plumbing shared by every entry point of the port.

The rule is the same everywhere: an explicit ``device`` wins; otherwise
the device of the tensors the caller handed over (speedup leaves
included); otherwise CUDA.  Asking for CUDA on a machine without a GPU
raises — nothing falls back to the CPU unless the caller said so.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "as_tensor", "stops_early"]


def resolve_device(device=None, *inputs) -> torch.device:
    """Device an entry point runs on (see the module docstring)."""
    if device is not None:
        dev = torch.device(device)
    else:
        dev = None
        for x in inputs:
            if isinstance(x, torch.Tensor):
                dev = x.device
                break
            leaf_dev = getattr(x, "device", None)
            if isinstance(leaf_dev, torch.device):
                dev = leaf_dev
                break
        if dev is None:
            dev = torch.device("cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default and no GPU is available; "
            "pass device='cpu' (or CPU tensors) to run on the CPU")
    return dev


def as_tensor(x, device, dtype=None) -> torch.Tensor:
    """``x`` as a tensor on ``device``; floats default to float64.

    Python floats and numpy arrays keep double precision (a bare
    ``torch.tensor(0.1)`` would be float32).  A tensor keeps its own
    dtype unless ``dtype`` is given.
    """
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    arr = np.asarray(x)
    if dtype is None:
        dtype = torch.bool if arr.dtype == np.bool_ else (
            torch.int64 if arr.dtype.kind in "iu" else torch.float64)
    return torch.tensor(arr, dtype=dtype, device=device)


def stops_early(frozen: torch.Tensor, sync: bool = False) -> bool:
    """May a fixed-count loop stop now that ``frozen`` rows stopped moving?

    Loops over a carry that every row freezes (a ``done`` mask, or a
    bisection that reached its fixed point) give the same result whether
    they run out their count or stop once all rows are frozen.  On the
    CPU the check is free, so loops stop; on the card reading the flag
    syncs the host to the device, so loops run out their count unless
    ``sync`` says a step is worth more than a sync (a scenario-engine
    event: a policy call of hundreds to thousands of kernels).
    """
    if frozen.device.type != "cpu" and not sync:
        return False
    return bool(frozen.all())
