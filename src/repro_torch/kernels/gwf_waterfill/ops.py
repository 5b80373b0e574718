"""Dispatch between the CUDA water-filling kernels and their plain versions.

``impl`` keeps the JAX package's contract with "cuda" in place of
"pallas"/"interpret":

  * "cuda" on a CUDA tensor launches the kernel (or raises); on a CPU
    tensor it runs the plain version — the only place the plain version
    stands in for the kernel;
  * "ref" runs the plain version wherever the tensor lies;
  * "sorted" (hetero op only) runs ``core.gwf.solve_cap_hetero_sorted``;
  * "auto" launches the kernel on a float32 CUDA tensor at every size
    and runs the plain version on any other: a CPU tensor, or a CUDA
    tensor of another dtype, which the plain version computes in its own
    dtype (the kernels compute in float32, so a float64 call would come
    back at float32 precision).  The rule is ``core.gwf.auto_impl``'s,
    the one ``solve_cap_batched`` follows.  (The TPU's size threshold is
    a fact of that chip; a threshold for this card waits for a
    measurement of its own.)
"""
from __future__ import annotations

import torch

from .._build import use_cuda_for
from ...core.gwf import auto_impl, solve_cap_hetero_sorted
from ...core.speedup import StackedSpeedup, unchecked
from .kernel import generic_waterfill, gwf_waterfill, hetero_waterfill
from .ref import generic_waterfill_ref, gwf_waterfill_ref, hetero_waterfill_ref

__all__ = [
    "gwf_waterfill_op",
    "generic_waterfill_op",
    "hetero_waterfill_op",
    "gwf_waterfill_ref",
    "generic_waterfill_ref",
    "hetero_waterfill_ref",
]


def _launches(x, impl, family):
    """Does this call launch the kernel?  ``impl`` as in the module
    docstring; "auto" asks ``auto_impl`` with the input's dtype."""
    if impl == "auto":
        return auto_impl(x.device.type, x.dtype, family) == "cuda"
    return use_cuda_for(x, impl)


def gwf_waterfill_op(u, h0, b, iters=64, impl="auto"):
    """Single-instance regular WFP; see the module docstring for ``impl``."""
    if impl == "sorted":
        raise ValueError("impl='sorted' applies to hetero_waterfill_op only")
    if _launches(u, impl, "regular"):
        return gwf_waterfill(u, h0, b, iters=iters)
    return gwf_waterfill_ref(u, h0, b)


def generic_waterfill_op(c, A, w, gamma, b, sigma=1, iters=64, impl="auto"):
    """Batched generic waterfill (N instances × K jobs)."""
    if impl == "sorted":
        raise ValueError("impl='sorted' applies to hetero_waterfill_op only")
    if _launches(c, impl, "regular"):
        return generic_waterfill(c, A, w, gamma, b, sigma=sigma, iters=iters)
    return generic_waterfill_ref(c, A, w, gamma, b, sigma=sigma, iters=iters)


def hetero_waterfill_op(c, A, w, gamma, sigma, b, iters=64, impl="auto"):
    """Per-job-parameter waterfill (paper §7): (N, K) job-indexed
    families, σ a ±1 array.  ``impl="sorted"`` runs the sorted-bracket
    solver over the instances instead of a bisection."""
    if impl == "sorted":
        return _hetero_sorted(c, A, w, gamma, sigma, b, iters=iters)
    if _launches(c, impl, "per_job"):
        return hetero_waterfill(c, A, w, gamma, sigma, b, iters=iters)
    return hetero_waterfill_ref(c, A, w, gamma, sigma, b, iters=iters)


def _hetero_sorted(c, A, w, gamma, sigma, b, iters=48):
    """Sorted-bracket per-job solve on the kernel's calling convention
    (inactive slots marked by c = 0)."""
    def full(x):
        return torch.broadcast_to(
            torch.as_tensor(x, dtype=c.dtype, device=c.device), c.shape)

    sp = unchecked(StackedSpeedup, A=full(A), w=full(w), gamma=full(gamma),
                   sigma=full(sigma), B=0.0)
    b = torch.broadcast_to(torch.as_tensor(b, dtype=c.dtype,
                                           device=c.device), c.shape[:1])
    return solve_cap_hetero_sorted(sp, b, c, c > 0, iters=min(iters, 48))
