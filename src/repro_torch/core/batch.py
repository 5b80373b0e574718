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
job dimension beyond that are per job (paper §7): ``(N, M)`` leaves give
every job of every instance its own function, and the solve takes the
sorted per-job CAP.  ``smartfill_hetero_batched`` adds the per-instance
completion order (rows must otherwise already be in completion order).
Padded outputs are exact zeros.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import as_tensor, resolve_device
from .smartfill import (SmartFillSchedule, _fast_ok, _host, _on, _solo_order,
                        _solve, _validate_instance)
from .speedup import (Speedup, collapse_homogeneous, host_call, map_leaves,
                      per_instance)

__all__ = [
    "BatchedSmartFillSchedule",
    "batch_axes",
    "check_axes_unambiguous",
    "current_allocations_from",
    "hetero_order_batch",
    "smartfill_batched",
    "smartfill_hetero_batched",
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


def _leaf_shapes(obj):
    """Shapes of the numeric leaves of a speedup or of an object (a
    policy) whose ``LEAVES`` name speedups, tensors, arrays, scalars,
    nested policies or tuples of them (a ladder's rungs)."""
    for name in obj.LEAVES:
        v = getattr(obj, name)
        for x in (v if isinstance(v, tuple) else (v,)):
            if x is None:
                continue
            if hasattr(x, "LEAVES"):
                yield from _leaf_shapes(x)
            else:
                yield tuple(x.shape) if hasattr(x, "shape") else np.shape(x)


def check_axes_unambiguous(sp, K: int, M: int, what: str) -> None:
    """With K == M a 1-D (K,) leaf could equally be per-job data; refuse
    to guess (a wrong guess silently corrupts every instance).  ``sp``
    is a speedup or a policy (its speedup's leaves included)."""
    if K != M:
        return
    for shape in _leaf_shapes(sp):
        if len(shape) == 1 and shape[0] == K:
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
      sp: shared speedup, or one with per-instance (N,) leaves, or per
        job ((M,) or (N, M) leaves, paper §7; rows in completion order).
      X, W: (N, M) padded sizes and weights.
      B: scalar or (N,) budgets; defaults to sp.B.
      active: optional (N, M) prefix masks; defaults to ``X > 0``.
      fast_path: as in ``smartfill``.
      validate: host-side check of each instance's sorting convention.
        The prefix-mask property is always checked.
      stol_rel: the per-job μ* descent's exit tolerance (see
        ``smartfill._solve``); None keeps the size-dependent default.
      device: where to run; defaults to the inputs' device, else CUDA.
    """
    dev = resolve_device(device, X, sp)
    Xm, Wm, active, m = _prepare(X, W, active, dev)
    N, M = Xm.shape
    Bv = as_tensor(sp.B if B is None else B, dev, Xm.dtype).expand(N)
    if validate:
        validate_padded_instances(Xm, Wm, m)
    sp = collapse_homogeneous(_on(sp, dev, Xm.dtype))
    check_axes_unambiguous(sp, N, M, "sp")
    fast = _fast_ok(sp, N) and fast_path is not False
    theta, c, a, d, T, J, J_lin, _, _ = _solve(
        sp, Xm, Wm, Bv.contiguous(), m, coarse, descent_iters, cap_iters,
        fast, stol_rel=stol_rel)
    return BatchedSmartFillSchedule(theta=theta, c=c, a=a, durations=d, T=T,
                                    J=J, J_linear=J_lin, active=active, m=m)


def smartfill_hetero_batched(sp: Speedup, X, W, B=None, active=None,
                             device=None, **kwargs):
    """Per-job batched planning: per-instance completion order + solve.

    The fleet front door for per-job speedups (paper §7): each padded
    instance's order is SJF by normalized size under each job's own s_i
    (``normalized_order``, ties by weight), rows and per-job speedup
    leaves are permuted to it, and the whole batch is solved in one
    ``smartfill_batched`` call.  Rows of X/W need not arrive sorted;
    padding stays a prefix.  The exchange search is the single-instance
    planner's (``smartfill_hetero``), not the fleet path's.

    Returns ``(orders, BatchedSmartFillSchedule)``, ``orders[n][r]`` the
    original column of instance n in schedule row r.
    """
    dev = resolve_device(device, X, sp)
    Xm, Wm, active, m = _prepare(X, W, active, dev)
    N, M = Xm.shape
    B = sp.B if B is None else B
    sp = collapse_homogeneous(_on(sp, dev, Xm.dtype))
    check_axes_unambiguous(sp, N, M, "sp")
    orders, sp_p, Xp, Wp = hetero_order_batch(sp, Xm, Wm, m, B)
    sched = smartfill_batched(sp_p, Xp, Wp, B=B, active=active, device=dev,
                              **kwargs)
    return orders, sched


def hetero_order_batch(sp, Xm, Wm, m, B):
    """Per-instance §7 order heuristic + batch permutation.

    For each padded instance the SJF-by-normalized-size order of its
    live prefix (the rates s_i(B_n) of every job of every instance come
    from one device call; the orders are host numpy), then rows and
    per-job speedup leaves permuted to it.  ``Xm``/``Wm``/``m`` follow
    ``_prepare``'s conventions.  Returns ``(orders, sp_p, Xp, Wp)``.
    """
    N, M = Xm.shape
    Xh, Wh, ms = _host(Xm), _host(Wm), _host(m).astype(np.int64)
    Bv = np.broadcast_to(_host(B), (N,)).copy()
    rate = np.broadcast_to(host_call(per_instance(sp, N), "s", Bv[:, None]),
                           (N, M))
    orders = np.tile(np.arange(M), (N, 1))
    for n in range(N):
        mk = int(ms[n])
        if mk:
            orders[n, :mk] = _solo_order(Xh[n, :mk], Wh[n, :mk],
                                         rate[n, :mk])
    gather = torch.as_tensor(orders, device=Xm.device)

    def permute_leaf(l):
        if l.ndim == 2 and l.shape == (N, M):
            return l.gather(1, gather)
        if l.ndim == 1 and l.shape[0] == M:
            return l[gather]        # shared per-job → per-instance copies
        return l

    return (orders, map_leaves(sp, permute_leaf), Xm.gather(1, gather),
            Wm.gather(1, gather))


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
