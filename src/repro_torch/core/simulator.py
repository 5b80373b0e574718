"""Event-driven execution of scheduling policies (host reference loop).

Between events allocations are constant, so the next event is the
earliest of a completion min_i rem_i / s(θ_i) and a pending arrival; at
each event the policy is re-invoked on the updated remaining sizes.
Exact for piecewise-constant policies (SmartFill, heSRPT, Prop. 7).

This part of the port carries the numpy event loop
(``simulate_policy_reference``) and ``simulate_policy``'s dispatch for
host callables, which is what the heSRPT comparison of the quickstart
needs.  The device engine for traceable policies, ensembles and fault
traces come with a later slice; asking for them raises.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .speedup import host_call

__all__ = [
    "SimResult",
    "n_events_for",
    "simulate_policy",
    "simulate_policy_reference",
]

_ENGINE_LATER = ("the device simulation engine (policies marked "
                 "device_ready, fault traces) comes with a later slice of "
                 "the PyTorch port")


@dataclasses.dataclass(frozen=True)
class SimResult:
    T: np.ndarray          # completion time per job
    J: float               # Σ w_i T_i (inf if any job failed to finish)
    events: list           # (t, allocations) trace
    n_events: int


def n_events_for(M: int) -> int:
    """Fixed event budget of the device engine: 4M + 16."""
    return 4 * int(M) + 16


def _validate_workload(x, w, arrival=None, what: str = "simulate_policy"):
    for name, arr in (("x (sizes)", x), ("w (weights)", w)):
        if not np.all(np.isfinite(arr)):
            raise ValueError(f"{what}: {name} must be finite; got "
                             f"min={np.min(arr)!r} max={np.max(arr)!r}")
        if np.any(arr < 0):
            raise ValueError(f"{what}: {name} must be ≥ 0 "
                             f"(size 0 = padding); got min={np.min(arr)!r}")
    if arrival is not None and np.isnan(np.asarray(arrival)).any():
        raise ValueError(f"{what}: arrival times must not be NaN")


def _validate_budget(B, what: str):
    if B is None:
        return
    arr = np.asarray(B, dtype=np.float64)
    if not np.all(np.isfinite(arr)) or np.any(arr <= 0):
        raise ValueError(f"{what}: B must be finite and > 0, got {arr!r}")


def simulate_policy(sp, x, w, policy, B=None, arrival=None,
                    rtol: float = 1e-12, max_events: int | None = None,
                    faults=None):
    """Run ``policy`` to completion under true speedup ``sp``.

    Plain host callables run on the numpy reference loop.  Traceable
    policies (``device_ready``) and fault traces belong to the device
    engine, which is not ported yet.
    """
    if getattr(policy, "device_ready", False) or faults is not None:
        raise NotImplementedError(_ENGINE_LATER)
    return simulate_policy_reference(sp, x, w, policy, B=B, arrival=arrival,
                                     rtol=rtol, max_events=max_events)


def simulate_policy_reference(sp, x, w, policy, B: float | None = None,
                              arrival=None, rtol: float = 1e-12,
                              max_events: int | None = None, faults=None):
    """Numpy event loop oracle.

    policy(rem, w, active) → (M,) allocations with Σ over active ≤ B.
    Raises on budget violations, deadlock and event-budget exhaustion.
    ``sp.s`` is evaluated on the speedup's own device.
    """
    if faults is not None:
        raise NotImplementedError(_ENGINE_LATER)
    x = np.asarray(x, dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)
    _validate_workload(x, w, arrival, what="simulate_policy_reference")
    _validate_budget(B, "simulate_policy_reference")
    M = x.shape[0]
    Bcur = float(getattr(sp, "B", 0.0) if B is None else B)
    real = x > 0
    arr = (np.zeros(M) if arrival is None
           else np.asarray(arrival, dtype=np.float64))
    rem = np.where(real, x, 0.0)
    T = np.zeros(M)
    t = 0.0
    events = []
    limit = max_events or n_events_for(M)
    tol = max(rtol, 8.0 * np.finfo(np.float64).eps) * max(
        1.0, float(x.max()) if M else 1.0)

    for _ in range(limit):
        arrived = real & (arr <= t)
        active = arrived & (rem > 0)
        pending = real & ~arrived
        if not active.any() and not pending.any():
            return SimResult(T=T, J=float(np.sum(w * T)), events=events,
                             n_events=len(events))
        raw = policy(rem, w, active)
        theta = np.where(active, np.asarray(raw, dtype=np.float64), 0.0)
        if theta[active].sum() > Bcur * (1 + 1e-9):
            raise ValueError("policy exceeded bandwidth budget")
        rates = np.where(active, host_call(sp, "s", theta), 0.0)
        runnable = active & (rates > 0)
        if not runnable.any() and not pending.any():
            raise RuntimeError("deadlock: no active job has positive rate")
        dt_c = (float(np.min(rem[runnable] / rates[runnable]))
                if runnable.any() else np.inf)
        t_arr = float(np.min(arr[pending])) if pending.any() else np.inf
        t_next = min(t + dt_c, t_arr)
        events.append((t, theta.copy()))
        dt = t_next - t
        t = t_next
        rem = np.where(active, rem - rates * dt, rem)
        done = active & (rem <= tol)
        T[done] = t
        rem[done] = 0.0
    raise RuntimeError(f"exceeded {limit} events — policy may not complete jobs")
