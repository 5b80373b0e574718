"""Scenario engine: event-driven execution of scheduling policies.

Between events allocations are constant, so the next event is the
earliest of (a) a completion min_i rem_i / s(θ_i), (b) a pending arrival
and (c) a pending fault; at each event the policy is re-invoked on the
updated remaining sizes.  Exact for piecewise-constant policies (which
SmartFill, heSRPT and every policy in ``sched/policies.py`` are,
Prop. 7) — no time discretization error.

Two executors share these semantics:

``simulate_policy`` (device engine)
    One batch-first event loop over (K, M) tensors: every step advances
    all K workloads by one event, calling the policy once for all of
    them.  It runs the fixed event count 4M + 16 (+2 per fault event) —
    enough for M completions plus M arrival events with a 2×+16 safety
    margin.  Jobs are padded (size 0 ⇒ never active), arrivals are
    folded in as events and halting is a masked no-op per workload.  The
    loop stops once every workload has halted (one host sync an event
    on the card), which gives what the full count gives, ``n_events``
    included.  Policies are
    ``sched/policies.py`` objects marked ``device_ready``; plain host
    callables go to the reference loop.

``simulate_policy_reference`` (host oracle)
    A numpy event loop, the differential-test oracle for the engine,
    with the same arrival and fault semantics.

``simulate_fluid_classes`` executes a policy over class aggregates
(``core/classes.py``) in the many-jobs limit: class work drains
continuously and an event is a class running dry.

``simulate_ensemble`` evaluates P policies × K workloads: a Python loop
over the policies, each one event loop over the shared (K, M) state.
Speedup and policy parameters may be batched per workload: a leaf with
leading dimension K belongs to one workload each.

**Fault schedules** (``faults=`` on every executor): a ``FaultTrace``
holds a sorted sequence of timed control-plane events folded into the
event horizon exactly like arrivals:

  * ``KIND_BUDGET``    — the server budget becomes ``value``.  Policies
    are invoked with the *current* budget (the optional 4th argument of
    the policy interface), so re-planning policies re-solve under B(t)
    and cached plans invalidate instead of executing a stale table.
  * ``KIND_FAILURE``   — job ``job`` restarts, losing the fraction
    ``value`` of its completed work (rem += value·(x − rem)).
    Completions are resolved first: a failure coincident with (or
    after) a job's completion is a no-op.
  * ``KIND_STRAGGLER`` — job ``job``'s service rate is scaled by
    ``value`` from now on; ``value = 1`` is recovery.

At most one fault applies per event; coincident faults drain through
dt = 0 events.

Used for cross-checking SmartFill's predicted J against an independent
execution of its schedule, and for evaluating baseline policies (heSRPT,
EQUI, …) under a true concave s over large randomized ensembles (paper
§6).
"""
from __future__ import annotations

import dataclasses
import logging

import numpy as np
import torch

from .._device import as_tensor, resolve_device, stops_early
from .batch import check_axes_unambiguous
from .classes import class_speedup
from .speedup import host_call, map_leaves, per_instance

_log = logging.getLogger(__name__)

__all__ = [
    "SimResult",
    "EnsembleResult",
    "FaultTrace",
    "KIND_BUDGET",
    "KIND_FAILURE",
    "KIND_STRAGGLER",
    "budget_trace",
    "n_events_for",
    "simulate_policy",
    "simulate_policy_device",
    "simulate_policy_reference",
    "simulate_ensemble",
    "simulate_fluid_classes",
    "FluidClassResult",
    "schedule_policy",
    "smartfill_sim_policy",
]


@dataclasses.dataclass(frozen=True)
class SimResult:
    T: np.ndarray          # completion time per job
    J: float               # Σ w_i T_i (inf if any job failed to finish)
    events: list           # (t, allocations) trace
    n_events: int


@dataclasses.dataclass(frozen=True)
class EnsembleResult:
    """Stacked outcomes of P policies × K workloads (device tensors).

    J[p, k] = Σ_i w_i T_i of policy p on workload k (+inf where the
    policy failed to complete every job within the event budget);
    T: (P, K, M) completion times; finished: (P, K) all-jobs-done flags;
    n_events: (P, K) executed (non-halt) event counts;
    exhausted: (P, K) — True where the row is unfinished *because* the
    fixed event budget saturated (n_events hit the horizon), as opposed
    to e.g. a zero-allocation policy stalling.  Such a J = inf is an
    artifact of the horizon, not a verdict on the policy — raise
    ``n_events`` to resolve it; the runner also warns once per process.
    """

    J: torch.Tensor
    T: torch.Tensor
    finished: torch.Tensor
    n_events: torch.Tensor
    exhausted: torch.Tensor
    policy_names: tuple

    def __len__(self) -> int:
        return int(self.J.shape[0])


def n_events_for(M: int) -> int:
    """Fixed event budget of the device engine: 4M + 16."""
    return 4 * int(M) + 16


# Loud-once flag for event-budget exhaustion (module-level so the warning
# fires once per process).
_warned_event_budget = False


def _warn_event_budget(exhausted, n_events: int, where: str) -> None:
    """Warn (once per process) when rows returned J = inf only because
    the fixed event horizon saturated mid-run."""
    global _warned_event_budget
    if _warned_event_budget:
        return
    n_bad = int(torch.as_tensor(exhausted).sum())
    if n_bad:
        _warned_event_budget = True
        _log.warning(
            "%s: %d row(s) hit the fixed device event budget "
            "(n_events=%d) before finishing — their J=inf is a horizon "
            "artifact, not a policy verdict; raise n_events (see "
            "EnsembleResult.exhausted; further occurrences are silent)",
            where, n_bad, n_events)


# ---------------------------------------------------------------------------
# Fault traces (dynamic budgets, failures, stragglers)
# ---------------------------------------------------------------------------

KIND_BUDGET = 0      # value = new server budget B(t)
KIND_FAILURE = 1     # job restarts, losing fraction `value` of done work
KIND_STRAGGLER = 2   # job's effective rate is scaled by `value` from now on


@dataclasses.dataclass(frozen=True)
class FaultTrace:
    """Seeded, replayable control-plane fault schedule (numpy arrays).

    times:  (S,) or (K, S) non-decreasing event times (+inf = padding).
    kinds:  int array, same shape — KIND_BUDGET / KIND_FAILURE /
            KIND_STRAGGLER per event (ignored on +inf padding slots).
    jobs:   int array, same shape — target job for FAILURE / STRAGGLER
            (ignored for BUDGET; use 0).
    values: float array, same shape — payload: the new budget (> 0), the
            lost fraction of completed work in [0, 1], or the new rate
            multiplier (> 0; a full stop would deadlock the host oracle
            while the engine pads J to +inf, so ``validate`` rejects it).

    The 2-D form carries one trace per workload for ensemble runs;
    ``instance(k)`` extracts a single row.  Build via
    ``core.workloads.sample_fault_traces`` (seeded chaos) or
    ``budget_trace`` (pure B(t) steps).
    """

    times: np.ndarray
    kinds: np.ndarray
    jobs: np.ndarray
    values: np.ndarray

    def __post_init__(self):
        object.__setattr__(self, "times", np.asarray(self.times, np.float64))
        object.__setattr__(self, "kinds", np.asarray(self.kinds, np.int32))
        object.__setattr__(self, "jobs", np.asarray(self.jobs, np.int32))
        object.__setattr__(self, "values", np.asarray(self.values, np.float64))

    @property
    def S(self) -> int:
        return int(self.times.shape[-1])

    @property
    def batched(self) -> bool:
        return self.times.ndim == 2

    def instance(self, k: int) -> "FaultTrace":
        if not self.batched:
            return self
        return FaultTrace(self.times[k], self.kinds[k], self.jobs[k],
                          self.values[k])

    def validate(self, M: int) -> None:
        """Host-side shape/semantics checks; raises ValueError."""
        t, k, j, v = self.times, self.kinds, self.jobs, self.values
        if t.ndim not in (1, 2):
            raise ValueError(f"FaultTrace.times must be 1-D or 2-D, got "
                             f"shape {t.shape}")
        if not (k.shape == t.shape == j.shape == v.shape):
            raise ValueError("FaultTrace arrays must share one shape, got "
                             f"times{t.shape} kinds{k.shape} jobs{j.shape} "
                             f"values{v.shape}")
        if np.isnan(t).any() or (t < 0).any():
            raise ValueError("FaultTrace.times must be ≥ 0 (NaN forbidden; "
                             "+inf = padding)")
        if not np.all(t[..., :-1] <= t[..., 1:]):
            raise ValueError("FaultTrace.times must be non-decreasing "
                             "per trace (inf-padded at the end)")
        live = np.isfinite(t)
        if not np.isin(k[live], (KIND_BUDGET, KIND_FAILURE,
                                 KIND_STRAGGLER)).all():
            raise ValueError("FaultTrace.kinds must be KIND_BUDGET/"
                             "KIND_FAILURE/KIND_STRAGGLER")
        targeted = live & np.isin(k, (KIND_FAILURE, KIND_STRAGGLER))
        if ((j[targeted] < 0) | (j[targeted] >= M)).any():
            raise ValueError(f"FaultTrace.jobs must lie in [0, {M}) for "
                             "failure/straggler events")
        vb = v[live & (k == KIND_BUDGET)]
        if (~np.isfinite(vb) | (vb <= 0)).any():
            raise ValueError("budget events need a finite value > 0")
        vf = v[live & (k == KIND_FAILURE)]
        if (~np.isfinite(vf) | (vf < 0) | (vf > 1)).any():
            raise ValueError("failure events need a loss fraction in [0, 1]")
        vs = v[live & (k == KIND_STRAGGLER)]
        if (~np.isfinite(vs) | (vs <= 0)).any():
            raise ValueError("straggler events need a finite rate "
                             "multiplier > 0")


def budget_trace(times, values) -> FaultTrace:
    """Pure budget schedule B(t): step to ``values[i]`` at ``times[i]``."""
    times = np.asarray(times, np.float64)
    values = np.asarray(values, np.float64)
    return FaultTrace(times=times, kinds=np.zeros(times.shape, np.int32),
                      jobs=np.zeros(times.shape, np.int32), values=values)


def _prepared_faults(faults: FaultTrace, M: int, K: int, like,
                     single: bool = False):
    """Validate and lower a FaultTrace to (K, S+1) tensors on ``like``'s
    device: times and values in its dtype, kinds and jobs int64.

    Appends one +inf sentinel event so the loop can read ``times[fi]``
    with ``fi`` up to S; 1-D traces are broadcast to every workload.
    ``single`` (the single-instance executors) requires a 1-D trace.
    """
    faults.validate(M)
    t = faults.times
    if single and t.ndim != 1:
        raise ValueError("single-instance executors need a 1-D FaultTrace "
                         "(use .instance(k) to pick one row)")
    pad = np.full(t.shape[:-1] + (1,), np.inf)
    t = np.concatenate([t, pad], axis=-1)
    k = np.concatenate([faults.kinds, np.full(pad.shape, -1, np.int32)],
                       axis=-1)
    j = np.concatenate([faults.jobs, np.zeros(pad.shape, np.int32)], axis=-1)
    v = np.concatenate([faults.values, np.zeros(pad.shape)], axis=-1)
    if t.ndim == 1:
        t, k, j, v = (np.broadcast_to(a, (K,) + a.shape) for a in (t, k, j, v))
    elif t.shape[0] != K:
        raise ValueError(f"batched FaultTrace has {t.shape[0]} traces "
                         f"for K={K} workloads")
    dev, dt = like.device, like.dtype
    return (as_tensor(np.ascontiguousarray(t), dev, dt),
            as_tensor(np.ascontiguousarray(k), dev, torch.int64),
            as_tensor(np.ascontiguousarray(j), dev, torch.int64),
            as_tensor(np.ascontiguousarray(v), dev, dt))


def _fault_n_events(M: int, S: int) -> int:
    """Default event budget with faults: each fault consumes one event
    and each failure can force one extra completion."""
    return n_events_for(M) + 2 * int(S)


# ---------------------------------------------------------------------------
# Input validation: negative / non-finite sizes, weights or budgets would
# flow into the loop and surface as NaN J.
# ---------------------------------------------------------------------------

def _host(a) -> np.ndarray:
    """Host numpy view of a tensor, array or scalar."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _validate_workload(x, w, arrival=None, what: str = "simulate_policy"):
    for name, a in (("x (sizes)", x), ("w (weights)", w)):
        arr = _host(a)
        if not np.all(np.isfinite(arr)):
            raise ValueError(f"{what}: {name} must be finite; got "
                             f"min={np.min(arr)!r} max={np.max(arr)!r}")
        if np.any(arr < 0):
            raise ValueError(f"{what}: {name} must be ≥ 0 "
                             f"(size 0 = padding); got min={np.min(arr)!r}")
    if arrival is not None and np.isnan(_host(arrival)).any():
        raise ValueError(f"{what}: arrival times must not be NaN")


def _validate_budget(B, what: str, source: str = "B"):
    if B is None:
        return
    arr = _host(B).astype(np.float64)
    if not np.all(np.isfinite(arr)) or np.any(arr <= 0):
        raise ValueError(f"{what}: {source} must be finite and > 0, "
                         f"got {arr!r}")


def _check_policy_budget(policy, B):
    """The engine spends the *policy's* budget; a caller-supplied B is a
    cross-check only.  Raise on a mismatch instead of silently
    simulating a different budget than the caller asked for."""
    if B is None:
        return
    pB = getattr(policy, "B", None)
    if pB is None:
        return
    try:
        ok = np.allclose(_host(B).astype(np.float64),
                         _host(pB).astype(np.float64))
    except (TypeError, ValueError):
        return                      # non-broadcastable: trust the caller
    if not ok:
        raise ValueError(
            f"B={B} disagrees with {getattr(policy, 'name', policy)!r}'s "
            f"own budget {pB}; the engine executes the policy's B — "
            "construct the policy with the budget you want (per-workload "
            "budgets: give the policy a (K,)-shaped B leaf)")


def _fault_B0(policy, B, what: str):
    """Initial budget B(0) for a faulted run: the caller's B, else the
    policy's own; faulted runs need one (the carry tracks it)."""
    B0 = B if B is not None else getattr(policy, "B", None)
    if B0 is None:
        raise ValueError(
            f"{what}: faulted runs need an initial budget — pass B= or use "
            "a policy with a B leaf")
    return B0


def lane_budget(B, K: int, like) -> torch.Tensor:
    """A budget (scalar, (K,) or (K, 1)) as a (K,) tensor in ``like``'s
    dtype and on its device."""
    b = as_tensor(B, like.device, like.dtype)
    if b.numel() == 1:
        return b.reshape(()).expand(K)
    return b.reshape(K)


# ---------------------------------------------------------------------------
# Device engine
# ---------------------------------------------------------------------------

def _bound(policy, dev, dtype):
    """``policy`` with its numeric leaves as tensors on ``dev``: one
    conversion per run instead of one per event."""
    bind = getattr(policy, "bind", None)
    return policy if bind is None else bind(dev, dtype)


def _sim_core(sp, policy, X, W, ARR, rtol: float, n_events: int,
              faults=None, B0=None, trace: bool = False):
    """Batch-first event loop over K workloads of M jobs.

    X, W, ARR: (K, M) sizes, weights and release times on one device;
    jobs with x == 0 are padding: never arrive, never run, T = 0.  ``sp``
    and ``policy`` are on that device in X's dtype.  Returns (T (K, M),
    finished (K,), n_events (K,), events) where events is None or, with
    ``trace``, (ts (n, K), thetas (n, K, M), valid (n, K)) over the n
    steps run.

    ``faults`` (prepared sentinel-terminated (K, S+1) tensors, see
    ``_prepared_faults``) switches to the fault-aware step: the carry
    also tracks the current budget B(t) per workload (from ``B0``), the
    per-job rate multipliers and a fault cursor.  The step advances to
    ``min(t + dt_completion, next_arrival, next_fault)``, resolves
    completions first, then applies at most one fault event.  With
    ``faults=None`` policies are invoked with the 3-argument form.

    A step at which a workload is not live (and completes nothing)
    leaves its state as it was, so every later step repeats it as a
    no-op; the loop stops once that holds for every workload (one host
    sync a step on the card, small beside a policy call).
    """
    K, M = X.shape
    dt_, dev = X.dtype, X.device
    spl = per_instance(sp, K, 1)
    real = X > 0
    rem = torch.where(real, X, 0.0)
    # completion tolerance: relative to the largest job, floored at a few
    # ulps of the working dtype so float32 runs still detect completions
    tol = (torch.clamp_min(X.amax(-1), 1.0)
           * max(float(rtol), 8.0 * torch.finfo(dt_).eps))[:, None]
    t = torch.zeros((K,), dtype=dt_, device=dev)
    T = torch.zeros((K, M), dtype=dt_, device=dev)
    n_ev = torch.zeros((K,), dtype=torch.int64, device=dev)
    inf = torch.tensor(torch.inf, dtype=dt_, device=dev)
    rec = []
    if faults is not None:
        ftimes, fkinds, fjobs, fvalues = faults
        S = ftimes.shape[1] - 1
        Bc = lane_budget(B0, K, X).clone()
        mult = torch.ones((K, M), dtype=dt_, device=dev)
        fi = torch.zeros((K,), dtype=torch.int64, device=dev)
        lane = torch.arange(M, device=dev)

    for _ in range(n_events):
        arrived = real & (ARR <= t[:, None])
        active = arrived & (rem > 0)
        if faults is None:
            raw = policy(rem, W, active)
        else:
            raw = policy(rem, W, active, Bc)
        theta = torch.where(active, raw, 0.0)
        rates = spl.s(theta)
        if faults is not None:
            rates = rates * mult
        rates = torch.where(active, rates, 0.0)
        runnable = active & (rates > 0)
        dt_c = torch.where(runnable,
                           rem / torch.where(runnable, rates, 1.0),
                           inf).amin(-1)
        pending = real & ~arrived
        t_arr = torch.where(pending, ARR, inf).amin(-1)
        t_next = torch.minimum(t + dt_c, t_arr)   # == t_arr on arrivals
        live = torch.isfinite(t_next)
        if faults is not None:
            idx = torch.clamp_max(fi, S)[:, None]  # sentinel keeps it in range
            t_fault = ftimes.gather(1, idx)[:, 0]
            t_next = torch.minimum(t_next, t_fault)
            # faults alone are not work: once every real job is done (or
            # can never arrive) the workload halts even if faults remain
            live = torch.isfinite(t_next) & (active.any(-1)
                                             | pending.any(-1))
        t_new = torch.where(live, t_next, t)
        dt = (t_new - t)[:, None]
        rem2 = torch.where(active, rem - rates * dt, rem)
        done_now = active & (rem2 <= tol)
        T = torch.where(done_now, t_new[:, None], T)
        rem2 = torch.where(done_now, 0.0, torch.clamp_min(rem2, 0.0))
        if faults is not None:
            # completions above are resolved first; now at most one fault
            hit = live & (t_fault <= t_new)
            kind = fkinds.gather(1, idx)[:, 0]
            sel = lane[None, :] == fjobs.gather(1, idx)
            val = fvalues.gather(1, idx)[:, 0]
            Bc = torch.where(hit & (kind == KIND_BUDGET), val, Bc)
            # a failure only bites jobs that have arrived and still run
            failable = real & (ARR <= t_new[:, None]) & (rem2 > 0)
            lose = (hit & (kind == KIND_FAILURE))[:, None] & sel & failable
            rem2 = torch.where(
                lose, torch.minimum(rem2 + val[:, None] * (X - rem2), X),
                rem2)
            mult = torch.where((hit & (kind == KIND_STRAGGLER))[:, None]
                               & sel, val[:, None], mult)
            fi = fi + hit.to(fi.dtype)
        if trace:
            rec.append((t, theta, live))
        n_ev = n_ev + live.to(n_ev.dtype)
        t, rem = t_new, rem2
        if stops_early(~live & ~done_now.any(-1), sync=True):
            break
    finished = (~real | (rem <= 0)).all(-1)
    events = None
    if trace:
        events = tuple(torch.stack(z) for z in zip(*rec)) if rec else None
    return T, finished, n_ev, events


def _objective(W, T, finished):
    return torch.where(finished, (W * T).sum(-1), torch.inf)


def simulate_policy_device(sp, x, w, policy, B=None, arrival=None,
                           rtol: float = 1e-12, max_events: int | None = None,
                           trace: bool = True,
                           faults: FaultTrace | None = None,
                           device=None) -> SimResult:
    """Run a device-ready policy through the engine, one workload.

    policy(rem, w, active) → allocations with Σ over active ≤ B (see
    ``sched/policies.py``).  The bandwidth budget is the **policy's own
    B** — the ``B`` kwarg is only cross-checked against it (a mismatch
    raises).  ``arrival`` (optional) holds per-job release times; jobs
    are folded in as events.  Returns a host-materialized SimResult;
    jobs that did not complete within the 4M+16 event budget leave
    J = +inf.

    ``faults`` (a 1-D ``FaultTrace``) enables the fault-aware step: the
    policy is then invoked as ``policy(rem, w, active, B_t)`` with the
    current budget.  Runs on ``device``, else on the device of ``x`` or
    of ``sp``'s leaves, else on CUDA; in x's dtype (float64 for numpy).
    """
    _check_policy_budget(policy, B)
    _validate_workload(x, w, arrival, what="simulate_policy")
    _validate_budget(B, "simulate_policy")
    _validate_budget(getattr(policy, "B", None), "simulate_policy",
                     source=f"policy {getattr(policy, 'name', policy)!r}.B")
    dev = resolve_device(device, x, sp)
    x = as_tensor(x, dev)
    w = as_tensor(w, dev, x.dtype)
    M = int(x.shape[0])
    if M == 0:                          # match the reference: nothing to do
        return SimResult(T=np.zeros(0), J=0.0, events=[], n_events=0)
    arr = (torch.zeros_like(x) if arrival is None
           else as_tensor(arrival, dev, x.dtype))
    ft = B0 = None
    if faults is not None:
        ft = _prepared_faults(faults, M, 1, x, single=True)
        n_events = int(max_events or _fault_n_events(M, faults.S))
        B0 = _fault_B0(policy, B, "simulate_policy")
    else:
        n_events = int(max_events or n_events_for(M))
    sp = map_leaves(sp, lambda l: l.to(device=dev, dtype=x.dtype))
    T, finished, n_ev, events = _sim_core(
        sp, _bound(policy, dev, x.dtype), x[None], w[None], arr[None], rtol,
        n_events, faults=ft, B0=B0, trace=trace)
    J = float(_objective(w[None], T, finished)[0])
    T = _host(T[0]).astype(np.float64)
    if not trace or events is None:
        return SimResult(T=T, J=J, events=[], n_events=int(n_ev[0]))
    ts, thetas, valid = (_host(e[:, 0]) for e in events)
    out = [(float(ts[i]), thetas[i].astype(np.float64).copy())
           for i in np.flatnonzero(valid)]
    return SimResult(T=T, J=J, events=out, n_events=len(out))


def simulate_policy(sp, x, w, policy, B=None, arrival=None,
                    rtol: float = 1e-12, max_events: int | None = None,
                    faults: FaultTrace | None = None, device=None):
    """Run ``policy`` to completion under true speedup ``sp``.

    Dispatch: policies from ``sched/policies.py`` (marked
    ``device_ready``) run on the engine (on ``device``, see
    ``simulate_policy_device``); plain host callables run on the numpy
    reference loop.
    """
    if getattr(policy, "device_ready", False):
        return simulate_policy_device(sp, x, w, policy, B=B,
                                      arrival=arrival, rtol=rtol,
                                      max_events=max_events, faults=faults,
                                      device=device)
    return simulate_policy_reference(sp, x, w, policy, B=B, arrival=arrival,
                                     rtol=rtol, max_events=max_events,
                                     faults=faults)


# ---------------------------------------------------------------------------
# Ensemble runner: P policies × K workloads
# ---------------------------------------------------------------------------

def simulate_ensemble(sp, policies, X, W, arrival=None, B=None,
                      rtol: float = 1e-12,
                      n_events: int | None = None,
                      faults: FaultTrace | None = None,
                      device=None) -> EnsembleResult:
    """Evaluate P policies × K workloads, one event loop per policy.

    Args:
      sp: true speedup driving the dynamics.  Leaves with leading
        dimension K (e.g. per-workload parameters from
        ``core/workloads.py``) belong to one workload each; scalar
        leaves are shared.  (When K == M this is ambiguous for 1-D
        leaves and the call raises — reshape per-workload leaves to
        (K, 1).)
      policies: sequence of device-ready policies (``sched/policies.py``).
        Per-workload policy parameters batch the same way as ``sp`` —
        e.g. a (K,)-shaped ``B`` leaf gives each workload its own budget.
      X, W: (K, M) padded sizes / weights (size 0 ⇒ padding).
      arrival: optional (K, M) release times (0 = present at start).
      B: cross-check only — each policy spends its *own* B; a mismatch
        with a policy's budget raises.
      n_events: event budget per workload; defaults to 4M+16 (+2 per
        fault event when ``faults`` is given).
      faults: optional ``FaultTrace`` — 1-D (same trace for every
        workload) or (K, S) (one trace per workload).  Every policy then
        needs a B leaf (the initial budget of its fault carry).
      device: where to run; defaults to X's device or ``sp``'s, else
        CUDA.  The run's dtype is X's (float64 for numpy).

    Returns an EnsembleResult with all tensors still on the device.
    """
    dev = resolve_device(device, X, sp)
    X = as_tensor(X, dev)
    W = as_tensor(W, dev, X.dtype)
    if X.ndim != 2 or W.shape != X.shape:
        raise ValueError("X and W must both be (K, M)")
    K, M = X.shape
    _validate_workload(X, W, arrival, what="simulate_ensemble")
    _validate_budget(B, "simulate_ensemble")
    ARR = (torch.zeros_like(X) if arrival is None
           else as_tensor(arrival, dev, X.dtype))
    if ARR.shape != X.shape:
        raise ValueError("arrival must be (K, M)")
    policies = tuple(policies)
    if not policies:
        raise ValueError("need at least one policy")
    names = tuple(getattr(p, "name", type(p).__name__) for p in policies)
    if M == 0:                          # K empty instances: all-zero result
        P = len(policies)
        return EnsembleResult(
            J=torch.zeros((P, K), dtype=X.dtype, device=dev),
            T=torch.zeros((P, K, 0), dtype=X.dtype, device=dev),
            finished=torch.ones((P, K), dtype=torch.bool, device=dev),
            n_events=torch.zeros((P, K), dtype=torch.int64, device=dev),
            exhausted=torch.zeros((P, K), dtype=torch.bool, device=dev),
            policy_names=names)
    check_axes_unambiguous(sp, K, M, "sp")
    for p in policies:
        if not getattr(p, "device_ready", False):
            raise ValueError(
                f"policy {p!r} is not device-ready; use sched/policies.py")
        _check_policy_budget(p, B)
        _validate_budget(getattr(p, "B", None), "simulate_ensemble",
                         source=f"policy {getattr(p, 'name', p)!r}.B")
        check_axes_unambiguous(p, K, M, f"policy {getattr(p, 'name', p)!r}")
    ft = None
    if faults is not None:
        for p in policies:
            # the fault carry starts from each policy's own B
            _fault_B0(p, None, "simulate_ensemble")
        ft = _prepared_faults(faults, M, K, X)
        n_events = int(n_events or _fault_n_events(M, faults.S))
    else:
        n_events = int(n_events or n_events_for(M))
    sp = map_leaves(sp, lambda l: l.to(device=dev, dtype=X.dtype))
    Js, Ts, fins, nev = [], [], [], []
    for p in policies:
        pb = _bound(p, dev, X.dtype)
        T, finished, ne, _ = _sim_core(
            sp, pb, X, W, ARR, rtol, n_events, faults=ft,
            B0=None if ft is None else pb.B)
        Js.append(_objective(W, T, finished))
        Ts.append(T)
        fins.append(finished)
        nev.append(ne)
    J, T, finished, ne = (torch.stack(v) for v in (Js, Ts, fins, nev))
    # unfinished AND the executed-event count saturated the horizon ⇒ the
    # run was cut off, not stalled
    exhausted = (~finished) & (ne >= n_events)
    _warn_event_budget(exhausted, n_events, "simulate_ensemble")
    return EnsembleResult(J=J, T=T, finished=finished, n_events=ne,
                          exhausted=exhausted, policy_names=names)


# ---------------------------------------------------------------------------
# Fluid class-aggregate executor (many-jobs limit, core/classes.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FluidClassResult:
    """Outcome of the fluid class executor (on the host).

    T[c] is the exhaustion time of class c (0 for empty classes);
    J_jobs = Σ_c n⁰_c w_c T_c is the objective with every job of a class
    finishing at its exhaustion, the quantity ``plan_classes``
    optimizes; J_fluid = ∫ Σ_c w_c n_c(t) dt with the continuously
    draining count n_c(t) = R_c(t)/x_c (≤ J_jobs: mass that drains early
    stops accruing weight).  Both are inf for an unfinished run.
    ``events`` is the (t, Θ) trace of aggregate allocations per
    inter-event interval.
    """

    T: np.ndarray
    J_fluid: float
    J_jobs: float
    finished: bool
    events: list
    n_events: int


def _fluid_core(sp_agg, policy, R0, wx_ratio, W_agg, rtol, n_events):
    """Fluid event loop over the (C,) class aggregates.

    Aggregate work R_c drains at S_c(Θ_c), the family frozen at the
    initial counts; allocations are constant between events, so the
    next event is the earliest exhaustion among runnable classes.  Over
    one interval the weighted-count integral is closed form (n_c is
    affine in t): ∫ w_c n_c dt = (w_c/x_c)(R_c·dt − S_c(Θ_c)·dt²/2).
    The loop stops once a step neither advanced time nor completed a
    class (one host sync a step on the card): every later step of the
    ``n_events`` count would repeat it as a no-op.
    """
    real = R0 > 0
    eps = torch.finfo(R0.dtype).eps
    tol = max(rtol, 8.0 * eps) * max(1.0, float(R0.max()))
    t = torch.zeros((), dtype=R0.dtype, device=R0.device)
    R = torch.where(real, R0, 0.0)
    T = torch.zeros_like(R0)
    Jf = torch.zeros_like(t)
    rec = []
    for _ in range(n_events):
        active = real & (R > 0)
        theta = torch.where(active, policy(R, W_agg, active), 0.0)
        rates = torch.where(active, sp_agg.s(theta), 0.0)
        runnable = active & (rates > 0)
        dt_c = torch.where(runnable,
                           R / torch.where(runnable, rates, 1.0),
                           torch.inf).amin()
        live = torch.isfinite(dt_c)
        dt = torch.where(live, dt_c, 0.0)
        t_new = t + dt
        dJ = torch.where(active, wx_ratio * (R * dt - rates * dt * dt / 2.0),
                         0.0).sum()
        R2 = torch.where(active, torch.clamp_min(R - rates * dt, 0.0), R)
        done_now = active & (R2 <= tol)
        T = torch.where(done_now, t_new, T)
        R = torch.where(done_now, 0.0, R2)
        rec.append((t, theta, live & active.any()))
        t, Jf = t_new, Jf + dJ
        if stops_early(~live & ~done_now.any(), sync=True):
            break
    finished = bool((~real | (R <= 0)).all())
    return T, Jf, finished, rec


def simulate_fluid_classes(state, policy, rtol: float = 1e-12,
                           max_events: int | None = None,
                           trace: bool = True,
                           device=None) -> FluidClassResult:
    """Run a policy over class aggregates in the fluid limit.

    ``state`` is a ``core.classes.ClassState``; ``policy`` a
    ``sched/policies.py`` allocator called with the *aggregate*
    remaining work and the aggregate weights n_c·w_c, e.g.
    ``ClassSmartFillPolicy.from_classes(state)``.  Every event exhausts
    at least one class, so the default budget of 2C + 8 events is ample.
    Zero-count classes are inert (T = 0, never allocated).  Runs on
    ``device``, else on the device of the state's speedup, in float64.
    """
    counts, x, w = (_host(v) for v in (state.counts, state.sizes,
                                       state.weights))
    C = counts.shape[0]
    if C == 0:
        return FluidClassResult(T=np.zeros(0), J_fluid=0.0, J_jobs=0.0,
                                finished=True, events=[], n_events=0)
    dev = resolve_device(device, state.sp)
    sp_agg = class_speedup(map_leaves(state.sp, lambda l: l.to(dev)),
                           counts)
    live = counts > 0
    R0 = as_tensor(np.where(live, counts * x, 0.0), dev)
    W_agg = as_tensor(np.where(live, counts * w, 0.0), dev)
    # the x = 0 padding slots have R0 = 0: their ratio is never used
    wx = as_tensor(np.where(live, w / np.where(x > 0, x, 1.0), 0.0), dev)
    n_events = int(max_events or (2 * C + 8))
    T, Jf, finished, rec = _fluid_core(
        sp_agg, _bound(policy, dev, R0.dtype), R0, wx, W_agg, rtol,
        n_events)
    T = _host(T)
    valid = [bool(v) for _, _, v in rec]
    events = [(float(t_), _host(th)) for (t_, th, _), v in zip(rec, valid)
              if v] if trace else []
    inf = float("inf")
    return FluidClassResult(
        T=T, J_fluid=float(Jf) if finished else inf,
        J_jobs=float(np.sum(counts * w * T)) if finished else inf,
        finished=finished, events=events, n_events=int(sum(valid)))


# ---------------------------------------------------------------------------
# Host reference loop — the differential oracle for the engine.  Arrival
# and fault events use the same semantics.
# ---------------------------------------------------------------------------

def simulate_policy_reference(sp, x, w, policy, B: float | None = None,
                              arrival=None, rtol: float = 1e-12,
                              max_events: int | None = None,
                              faults: FaultTrace | None = None):
    """Numpy event loop oracle; the same event semantics as the engine.

    policy(rem, w, active) → (M,) allocations with Σ over active ≤ B.
    Raises on budget violations, deadlock and event-budget exhaustion —
    host-side checks the engine cannot afford.  ``sp.s`` is evaluated on
    the speedup's own device.

    With ``faults`` the oracle mirrors the fault-aware step exactly —
    current-budget policy invocation (4-argument form), completions
    before faults, one fault per event, faults alone are not work — and
    the runtime budget check tracks B(t).
    """
    x = np.asarray(_host(x), dtype=np.float64)
    w = np.asarray(_host(w), dtype=np.float64)
    _validate_workload(x, w, arrival, what="simulate_policy_reference")
    _validate_budget(B, "simulate_policy_reference")
    M = x.shape[0]
    if faults is None:
        Bcur = float(getattr(sp, "B", 0.0) if B is None else B)
    else:
        Bcur = float(_host(_fault_B0(policy, B, "simulate_policy_reference")))
    real = x > 0
    arr = (np.zeros(M) if arrival is None
           else np.asarray(_host(arrival), dtype=np.float64))
    rem = np.where(real, x, 0.0)
    T = np.zeros(M)
    mult = np.ones(M)
    t = 0.0
    events = []
    if faults is not None:
        faults.validate(M)
        if faults.batched:
            raise ValueError("the reference oracle runs one instance — "
                             "pass faults.instance(k)")
        ftimes, fkinds, fjobs, fvalues = (faults.times, faults.kinds,
                                          faults.jobs, faults.values)
        fi, S = 0, faults.S
        limit = max_events or _fault_n_events(M, S)
    else:
        fi, S = 0, 0
        limit = max_events or n_events_for(M)
    # same tolerance formula as the engine (float64 host side)
    tol = max(rtol, 8.0 * np.finfo(np.float64).eps) * max(
        1.0, float(x.max()) if M else 1.0)

    for _ in range(limit):
        arrived = real & (arr <= t)
        active = arrived & (rem > 0)
        pending = real & ~arrived
        if not active.any() and not pending.any():
            return SimResult(T=T, J=float(np.sum(w * T)), events=events,
                             n_events=len(events))
        if faults is None:
            raw = policy(rem, w, active)
        else:
            raw = policy(rem, w, active, Bcur)
        theta = np.where(active, _host(raw).astype(np.float64), 0.0)
        if theta[active].sum() > Bcur * (1 + 1e-9):
            raise ValueError("policy exceeded bandwidth budget")
        rates = np.where(active, host_call(sp, "s", theta) * mult, 0.0)
        runnable = active & (rates > 0)
        t_fault = float(ftimes[fi]) if fi < S else np.inf
        if not runnable.any() and not pending.any() \
                and not np.isfinite(t_fault):
            raise RuntimeError("deadlock: no active job has positive rate")
        dt_c = (float(np.min(rem[runnable] / rates[runnable]))
                if runnable.any() else np.inf)
        t_arr = float(np.min(arr[pending])) if pending.any() else np.inf
        t_next = min(t + dt_c, t_arr, t_fault)
        events.append((t, theta.copy()))
        dt = t_next - t
        t = t_next
        rem = np.where(active, rem - rates * dt, rem)
        done = active & (rem <= tol)
        T[done] = t
        rem[done] = 0.0
        if faults is not None and t_fault <= t:
            k, j, v = int(fkinds[fi]), int(fjobs[fi]), float(fvalues[fi])
            if k == KIND_BUDGET:
                Bcur = v
            elif k == KIND_FAILURE:
                # completions above resolved first: rem[j] == 0 ⇒ no-op
                if real[j] and arr[j] <= t and rem[j] > 0:
                    rem[j] = min(rem[j] + v * (x[j] - rem[j]), x[j])
            elif k == KIND_STRAGGLER:
                mult[j] = v
            fi += 1
    raise RuntimeError(f"exceeded {limit} events — policy may not complete jobs")


# ---------------------------------------------------------------------------
# Host policy wrappers (dispatched to the reference loop)
# ---------------------------------------------------------------------------

def schedule_policy(schedule):
    """Wrap a precomputed SmartFillSchedule as a re-planning policy.

    Looks up the phase by the number of remaining jobs (Prop. 7: the
    allocation depends only on the active set) — executing it through
    the simulator independently validates durations/T/J.
    """
    theta = _host(schedule.theta).astype(np.float64)

    def policy(rem, w, active):
        k = int(np.sum(active))         # phase k−1 has jobs 0..k−1 active
        out = np.zeros_like(np.asarray(rem, dtype=np.float64))
        idx = np.flatnonzero(active)
        # jobs complete in SJF order ⇒ active set is the k largest = 0..k−1
        out[idx] = theta[: k, k - 1][: idx.size]
        return out

    return policy


def smartfill_sim_policy(sp, B: float | None = None):
    """Re-planning SmartFill policy (time-consistency check).

    At every event, re-run SmartFill on the remaining sizes.  For the
    OPT setting this must reproduce the one-shot schedule's J.
    (Host-side, on the device of ``sp``'s leaves; the engine's
    equivalent is ``sched.policies.SmartFillPolicy``.)
    """
    from .smartfill import smartfill_allocations

    def policy(rem, w, active):
        rem = np.asarray(rem, dtype=np.float64)
        w = np.asarray(w, dtype=np.float64)
        out = np.zeros_like(rem)
        idx = np.flatnonzero(active)
        if idx.size == 0:
            return out
        order = idx[np.lexsort((w[idx], -rem[idx]))]
        th = smartfill_allocations(sp, rem[order], w[order], B=B)
        out[order] = _host(th)
        return out

    return policy
