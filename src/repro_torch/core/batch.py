"""Batched SmartFill planning — solve many scheduling instances at once.

The SmartFill core (``core/smartfill.py``) is batch-first, so a fleet of
independent (x, w, B) instances is planned in one call: thousands of
tenants, one stack of tensor operations per iteration, no Python loop
over instances.

Padding / masking convention (matches ``solve_cap``'s ``active`` mask):

  * all instances are padded to a common width M;
  * ``active`` is a **prefix** mask per instance — real jobs occupy
    slots 0..m−1, padding m..M−1;
  * padded slots carry x = 0, w = 0 (enforced internally);
  * within its prefix each instance is sorted the SmartFill way: sizes
    non-increasing, weights non-decreasing;
  * ``B`` is a scalar or an (N,) vector.

Speedup leaves with leading dimension N are per instance; leaves with a
job dimension beyond that are per job (paper §7), which the port does
not plan yet.  Padded outputs are exact zeros.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import as_tensor, resolve_device
from .smartfill import (_PER_JOB_LATER, SmartFillSchedule, _fast_ok, _on,
                        _solve, _validate_instance)
from .speedup import Speedup, collapse_homogeneous, inner_per_job, leaves

__all__ = [
    "BatchedSmartFillSchedule",
    "batch_axes",
    "check_axes_unambiguous",
    "current_allocations_from",
    "smartfill_batched",
    "smartfill_allocations_batched",
    "validate_padded_instances",
]


def batch_axes(sp, K: int) -> dict:
    """Which leaves of ``sp`` are per instance: {leaf name: 0 or None}.

    A leaf with leading dimension K maps along the instance axis (0);
    everything else is shared (None).  The JAX package's ``vmap``
    in_axes, as a dict.
    """
    return {name: 0 if (getattr(sp, name).ndim >= 1
                        and getattr(sp, name).shape[0] == K) else None
            for name in sp.LEAVES}


def check_axes_unambiguous(sp, K: int, M: int, what: str) -> None:
    """With K == M a 1-D (K,) leaf could equally be per-job data; refuse
    to guess (a wrong guess silently corrupts every instance)."""
    if K != M:
        return
    for leaf in leaves(sp):
        if leaf.ndim == 1 and leaf.shape[0] == K:
            raise ValueError(
                f"{what} has a 1-D leaf of length {K} but K == M — "
                "per-instance (K,) leaves cannot be told apart from "
                "per-job (M,) leaves; reshape per-instance leaves to "
                "(K, 1) (they broadcast) or pick K ≠ M")


def validate_padded_instances(X, W, m) -> None:
    """Host-check the sorting convention on each padded instance.

    Raises ValueError naming the first instance whose active prefix is
    not sizes-non-increasing with weights non-decreasing.
    """
    ms = np.asarray(torch.as_tensor(m).cpu())
    xs = np.asarray(torch.as_tensor(X).cpu())
    ws = np.asarray(torch.as_tensor(W).cpu())
    for n in range(xs.shape[0]):
        k = int(ms[n])
        if k == 0:
            continue
        try:
            _validate_instance(xs[n, :k], ws[n, :k])
        except ValueError as e:
            raise ValueError(f"instance {n}: {e}") from e


@dataclasses.dataclass(frozen=True)
class BatchedSmartFillSchedule:
    """Stacked SmartFill outputs for N padded instances.

    theta: (N, M, M); c/a/durations/T: (N, M); J/J_linear: (N,);
    active: (N, M) prefix masks; m: (N,) active-job counts.  All fields
    stay on the device until the caller reads them.
    """

    theta: torch.Tensor
    c: torch.Tensor
    a: torch.Tensor
    durations: torch.Tensor
    T: torch.Tensor
    J: torch.Tensor
    J_linear: torch.Tensor
    active: torch.Tensor
    m: torch.Tensor

    def __len__(self) -> int:
        return int(self.theta.shape[0])

    def instance(self, i: int) -> SmartFillSchedule:
        """Instance ``i`` as a plain SmartFillSchedule."""
        return SmartFillSchedule(
            theta=self.theta[i], c=self.c[i], a=self.a[i],
            durations=self.durations[i], T=self.T[i],
            J=float(self.J[i]), J_linear=float(self.J_linear[i]))


def _prepare(X, W, active, dev):
    X = as_tensor(X, dev)
    W = as_tensor(W, dev, X.dtype)
    if X.ndim != 2 or W.shape != X.shape:
        raise ValueError("X and W must both be (N, M)")
    if active is None:
        active = X > 0
    active = as_tensor(active, dev, torch.bool)
    if active.shape != X.shape:
        raise ValueError("active mask must be (N, M)")
    m = active.sum(1)
    # The solver reads only the *count* m with prefix semantics, so a
    # non-prefix mask would silently drop real jobs: reject it.
    prefix = (torch.arange(X.shape[1], device=dev)[None, :] < m[:, None])
    bad = (active != prefix).any(1)
    if bool(bad.any()):
        n = int(torch.nonzero(bad)[0, 0])
        raise ValueError(
            f"active must be a prefix mask per instance (real jobs "
            f"first, padding after); instance {n} has interior gaps")
    return (torch.where(active, X, 0.0), torch.where(active, W, 0.0),
            active, m)


def smartfill_batched(
    sp: Speedup,
    X,
    W,
    B=None,
    active=None,
    coarse: int = 32,
    descent_iters: int = 40,
    cap_iters: int = 64,
    fast_path: bool | None = None,
    validate: bool = False,
    stol_rel: float | None = None,
    device=None,
) -> BatchedSmartFillSchedule:
    """SmartFill over N padded instances in one batched call.

    Args:
      sp: shared speedup, or one with per-instance (N,) leaves.
      X, W: (N, M) padded sizes and weights.
      B: scalar or (N,) budgets; defaults to sp.B.
      active: optional (N, M) prefix masks; defaults to ``X > 0``.
      fast_path: as in ``smartfill``.
      validate: host-side check of each instance's sorting convention.
        The prefix-mask property is always checked.
      stol_rel: the per-job minimizer's exit tolerance; that path is not
        ported yet, so only the default None is accepted.
      device: where to run; defaults to the inputs' device, else CUDA.
    """
    if stol_rel is not None:
        raise NotImplementedError(
            "stol_rel tunes the per-job SmartFill minimizer; " + _PER_JOB_LATER)
    dev = resolve_device(device, X, sp)
    Xm, Wm, active, m = _prepare(X, W, active, dev)
    N, M = Xm.shape
    Bv = as_tensor(sp.B if B is None else B, dev, Xm.dtype).expand(N)
    if validate:
        validate_padded_instances(Xm, Wm, m)
    sp = collapse_homogeneous(_on(sp, dev, Xm.dtype))
    check_axes_unambiguous(sp, N, M, "sp")
    if inner_per_job(sp, N):
        raise NotImplementedError(_PER_JOB_LATER)
    fast = _fast_ok(sp, N) and fast_path is not False
    theta, c, a, d, T, J, J_lin = _solve(sp, Xm, Wm, Bv.contiguous(), m,
                                         coarse, descent_iters, cap_iters,
                                         fast)
    return BatchedSmartFillSchedule(theta=theta, c=c, a=a, durations=d, T=T,
                                    J=J, J_linear=J_lin, active=active, m=m)


def smartfill_allocations_batched(sp: Speedup, REM, W, B=None, active=None,
                                  **kwargs) -> torch.Tensor:
    """Instantaneous optimal allocations for N fleets in one call:
    column m−1 of each instance's plan.  Returns (N, M); padding is 0."""
    return current_allocations_from(
        smartfill_batched(sp, REM, W, B=B, active=active, **kwargs))


def current_allocations_from(sched: BatchedSmartFillSchedule) -> torch.Tensor:
    """Current-instant allocations of a solved batched plan (column m−1,
    the earliest phase, of each instance)."""
    N, M = sched.theta.shape[:2]
    col = torch.clamp(sched.m - 1, 0, M - 1)
    th = sched.theta.gather(2, col[:, None, None].expand(N, M, 1))[..., 0]
    return torch.where(sched.active & (sched.m > 0)[:, None], th, 0.0)
