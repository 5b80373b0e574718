"""Device and dtype plumbing shared by every entry point of the port.

The rule is the same everywhere: an explicit ``device`` wins; otherwise
the device of the tensors the caller handed over (speedup leaves
included); otherwise CUDA.  Asking for CUDA on a machine without a GPU
raises — nothing falls back to the CPU unless the caller said so.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "as_tensor", "stops_early", "vpow"]


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


# The CPU's elementwise loops run vector lanes over whole blocks of
# contiguous elements and a scalar loop over the rest; for pow the two
# round differently (last bits), so an element's result would depend on
# where it sits in the tensor — on the batch it was solved in.  Operands
# with a stride of two elements never take the vector lanes: every
# element then goes through the scalar pow.


def _spaced(t):
    """``t``'s values in a view whose last stride is two elements."""
    buf = torch.empty(t.shape + (2,), dtype=t.dtype, device=t.device)
    buf[..., 0] = t
    return buf[..., 0]


def vpow(base, exponent):
    """``base ** exponent``, elementwise, with each element's bits
    independent of its position in the tensor (and so of the batch).

    On CUDA (one thread an element) this is the plain operator; on the
    CPU every element takes the scalar pow (see the note above).  The
    result has the plain operator's dtype.
    """
    like = base if isinstance(base, torch.Tensor) else exponent
    if like.device.type != "cpu":
        return base ** exponent
    if not isinstance(exponent, torch.Tensor):
        return _spaced(base) ** exponent
    dt = torch.result_type(base, exponent)
    base = torch.as_tensor(base, dtype=dt)
    base, exponent = torch.broadcast_tensors(base, exponent.to(dt))
    return _spaced(base) ** _spaced(exponent)
