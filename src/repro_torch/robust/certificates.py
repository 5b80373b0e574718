"""Runtime plan certificates: is this allocation/plan safe to execute?

Two granularities, matching the two places a poisoned solve can leak
into execution:

``allocation_ok``
    One verdict per workload for an event's allocations θ — finite,
    non-negative, Σ over active ≤ B(t).  Batch-first: (K, M) allocations
    give a (K,) bool tensor, so one lane's failure never sends a healthy
    lane down the ladder; an (M,) call gives a 0-dim verdict.  Cheap
    enough to evaluate every event inside the engine's loop; this is
    what ``robust.degrade.DegradingPolicy`` gates each ladder rung on.

``certify_plan``
    A host-side certificate for a full SmartFill allocation table:
    finite θ everywhere, every phase column spends exactly the budget,
    every phase satisfies the CAP KKT system (``core.gwf.cap_residual``
    — the optimality conditions (9a)–(9d)), and the Prop. 9 identity
    J == Σ a_i x_i (= ``J_linear``) holds.  The pre-flight check for
    pinning a cached plan (``HeteroSmartFillPolicy.pinned``) or shipping
    one to the fleet: a plan that passes is feasible *and* optimal for
    its instance, not merely finite.  A non-converged μ* descent can
    emit a table that is finite but infeasible — only the KKT residuals
    catch that.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import as_tensor, resolve_device
from ..core.gwf import cap_residual
from ..core.speedup import map_leaves

__all__ = ["PlanCertificate", "allocation_ok", "certify_plan"]

_KKT = ("order", "ratio", "park")


def allocation_ok(theta, B, active, tol: float = 1e-6, device=None):
    """Per-workload feasibility certificate for one event's allocation.

    True where, over the active set, θ is finite, ≥ −tol·B (water-filling
    round-off may dip a hair below zero), and Σθ ≤ B·(1+tol).  ``theta``
    and ``active`` are (K, M) (one verdict per row, ``B`` a scalar or
    (K,)) or (M,) (a 0-dim verdict).  Tensor ops only: no host sync.
    """
    dev = resolve_device(device, theta, active, B)
    theta = as_tensor(theta, dev)
    if not theta.is_floating_point():
        theta = theta.double()
    active = as_tensor(active, dev, torch.bool)
    th = torch.where(active, theta, 0.0)
    Bv = as_tensor(B, dev, th.dtype)
    finite = torch.isfinite(th).all(-1) & torch.isfinite(Bv)
    nonneg = (th >= -tol * Bv[..., None]).all(-1)
    within = th.sum(-1) <= Bv * (1.0 + tol)
    return finite & nonneg & within


@dataclasses.dataclass(frozen=True)
class PlanCertificate:
    """Host-materialized verdict of ``certify_plan``.

    ok: every check below passed at its tolerance.
    finite: the whole table (and J, J_linear) is finite.
    budget: max over phases of |Σ_active θ − B| / B.
    kkt: max over phases of each ``cap_residual`` violation
      ("order", "ratio", "park") — ≤ tol everywhere ⟺ each phase solves
      its CAP, i.e. the plan is phase-wise optimal, not just feasible.
    j_gap: |J − J_linear| / max(1, |J|) — the Prop. 9 identity (NaN when
      it is not checked).
    """

    ok: bool
    finite: bool
    budget: float
    kkt: dict
    j_gap: float


def certify_plan(sp, sched, B=None, tol: float = 1e-6,
                 check_j_gap: bool = True, device=None) -> PlanCertificate:
    """Certify a SmartFill schedule before executing/caching it.

    ``sched`` is a ``SmartFillSchedule`` / ``HeteroSmartFillSchedule``
    (phase j = column j, jobs 0..j active).  For per-job schedules pass
    ``sp`` already permuted into the schedule's rank coordinates (the
    alignment the solver used).  ``B`` defaults to ``sp.B``.

    The KKT sweep is one ``cap_residual`` per phase column on the
    schedule's device; the residuals are reduced there and read on the
    host once.  ``check_j_gap=False`` skips the Prop. 9 identity for
    schedules where clamped back-substitution legitimately breaks it (an
    unrealized per-job order — see ``HeteroSmartFillSchedule``).
    """
    dev = resolve_device(device, sched.theta, sp)
    theta = as_tensor(sched.theta, dev)
    M = theta.shape[0]
    Bv = float(sp.B if B is None else B)
    J = float(sched.J)
    J_linear = float(getattr(sched, "J_linear", np.nan))
    scalars_finite = bool(np.isfinite(J) and (not check_j_gap
                                             or np.isfinite(J_linear)))
    if M == 0:
        return PlanCertificate(ok=scalars_finite, finite=scalars_finite,
                               budget=0.0, kkt=dict.fromkeys(_KKT, 0.0),
                               j_gap=0.0)

    sp = map_leaves(sp, lambda l: l.to(device=dev, dtype=theta.dtype))
    c = as_tensor(sched.c, dev, theta.dtype)
    lane = torch.arange(M, device=dev)
    rows = []
    for j in range(M):
        res = cap_residual(sp, Bv, c, theta[:, j], active=lane <= j,
                           tol=tol)
        rows.append(torch.stack([res[k] for k in ("budget",) + _KKT]))
    worst = torch.stack(rows).amax(0)
    fin = torch.isfinite(theta).all().to(theta.dtype)[None]
    host = torch.cat([worst, fin]).cpu().numpy()

    finite = bool(host[-1]) and scalars_finite
    budget = float(host[0]) / max(Bv, 1e-300)
    kkt = {k: float(v) for k, v in zip(_KKT, host[1:4])}
    j_gap = (abs(J - J_linear) / max(1.0, abs(J))
             if check_j_gap else float("nan"))
    ok = bool(finite and budget <= tol
              and all(v <= tol for v in kkt.values())
              and (not check_j_gap or j_gap <= tol))
    return PlanCertificate(ok=ok, finite=finite, budget=budget, kkt=kkt,
                           j_gap=j_gap)
