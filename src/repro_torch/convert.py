"""Carry a speedup's parameters over from the JAX package.

A JAX speedup is a pytree whose leaves are its parameters.  Hand them
over as numpy arrays (``np.asarray(sp.A)`` and so on) with ``sigma`` and
``B``, and ``speedup_from_arrays`` builds the port's object from exactly
those numbers on the device asked for.  This module reads plain arrays
only; it knows nothing of JAX.
"""
from __future__ import annotations

import torch

from ._device import as_tensor, resolve_device
from .core.speedup import GenericSpeedup, RegularSpeedup, StackedSpeedup

__all__ = ["speedup_from_arrays"]


def speedup_from_arrays(kind: str, *, B: float, A=None, w=None, gamma=None,
                        sigma=1, s_fn=None, ds_fn=None, inv_iters: int = 80,
                        device=None, dtype=torch.float64):
    """The port's speedup of class ``kind`` from arrays of its parameters.

    Args:
      kind: "RegularSpeedup", "StackedSpeedup" or "GenericSpeedup" — the
        class name on both sides.
      B: domain bound.
      A, w, gamma: parameter arrays of any shape (scalar, (M,), (N,),
        (N, M)); numpy, Python floats or tensors.
      sigma: ±1 for a RegularSpeedup; an array of ±1 for a StackedSpeedup.
      s_fn, ds_fn, inv_iters: a GenericSpeedup's callables on tensors and
        its bisection count (callables do not cross frameworks, so the
        caller writes them in torch).
      device, dtype: where the parameters live, float64 by default.
    """
    dev = resolve_device(device)
    if kind == "GenericSpeedup":
        if s_fn is None or ds_fn is None:
            raise ValueError("a GenericSpeedup needs s_fn and ds_fn")
        return GenericSpeedup(s_fn=s_fn, ds_fn=ds_fn, B=float(B),
                              inv_iters=int(inv_iters))
    leaves = dict(A=as_tensor(A, dev, dtype), w=as_tensor(w, dev, dtype),
                  gamma=as_tensor(gamma, dev, dtype))
    if kind == "RegularSpeedup":
        return RegularSpeedup(**leaves, sigma=int(sigma), B=float(B))
    if kind == "StackedSpeedup":
        return StackedSpeedup(**leaves, sigma=as_tensor(sigma, dev, dtype),
                              B=float(B))
    raise ValueError(f"unknown speedup kind {kind!r}")
