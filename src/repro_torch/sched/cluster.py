"""Cluster-level scheduler: SmartFill over competing training jobs.

The paper's abstract divisible server is, concretely, a pod: B chips
shared by M jobs whose speedup functions come from the roofline
calibration (``speedup_models.py``).  This module plans with SmartFill
and executes the plan with an event loop that charges real-world costs
the theory abstracts away:

  * reallocation cost — every allocation change means checkpoint + mesh
    re-instantiation + restore; the event loop charges
    ``realloc_cost_s`` of lost service to every resized job and merges
    reallocations below ``min_delta`` chips to avoid thrashing;
  * integer chips — allocations are rounded by largest remainder,
    preserving Σθ = B (integrality gap ≤ 1 chip a job);
  * online arrivals — the paper solves the all-at-t=0 problem (OPT); at
    each arrival the scheduler re-plans on the remaining sizes.  Between
    arrivals the plan is optimal (Prop. 7: allocations depend only on
    the active set); the arrival policy is a documented heuristic beyond
    the paper;
  * heterogeneous speedups (paper §7) — ``Job.speedup`` is honoured end
    to end: per-job functions are stacked into job-indexed leaves
    (``core.speedup.stack_speedups``), jobs are ranked by normalized
    size (size / sᵢ(B)) and planned with the heterogeneous SmartFill
    solver.  A job whose speedup cannot be stacked with the fleet's (a
    ``GenericSpeedup``) raises instead of falling back to the
    scheduler-wide function.

Planning runs where the speedup's leaves live (CUDA unless they lie on
the CPU), in float64, so SmartFill's inner CAP takes the closed form.
The host event loop (``simulate_host``) keeps its state in numpy float64
and reads each event's plan and rates from the device once.
"""
from __future__ import annotations

import dataclasses
import logging

import numpy as np

from ..core.batch import current_allocations_from, smartfill_batched
from ..core.speedup import (RegularSpeedup, Speedup, host_call,
                            stack_speedup_rows, stack_speedups)

__all__ = ["Job", "ClusterScheduler", "ClusterSimResult", "integerize"]

_log = logging.getLogger(__name__)
# the device→host re-run is worth one loud line per process, not one per
# simulate() call in a sweep
_warned_device_fallback = False


@dataclasses.dataclass(frozen=True)
class ClusterSimResult:
    """Outcome of ``ClusterScheduler.simulate``.

    ``path`` records which executor produced the result ("device" |
    "host"); ``status`` is "ok" unless the device engine exhausted its
    fixed event budget and the run was re-executed on the host loop
    ("device-event-budget-exhausted").  Iterates as ``(events, J)``.
    """

    events: list
    J: float
    path: str = "device"
    status: str = "ok"

    @property
    def ok(self) -> bool:
        return self.status == "ok"

    def __iter__(self):
        return iter((self.events, self.J))


@dataclasses.dataclass
class Job:
    name: str
    size: float                  # work remaining (e.g. tokens)
    weight: float = 1.0
    arrival: float = 0.0
    speedup: Speedup | None = None   # None → scheduler-wide function
    done: float | None = None
    allocated: float = 0.0


def integerize(theta, B: int):
    """Largest-remainder rounding preserving the chip budget (numpy)."""
    theta = np.asarray(theta, dtype=np.float64)
    used = theta.sum()
    if used <= 0:
        return np.zeros_like(theta, dtype=np.int64)
    scaled = theta / used * B
    base = np.floor(scaled).astype(np.int64)
    rem = scaled - base
    short = int(round(B - base.sum()))
    if short > 0:
        idx = np.argsort(-rem)[:short]
        base[idx] += 1
    return base


class ClusterScheduler:
    def __init__(self, speedup: Speedup, B: float,
                 realloc_cost_s: float = 0.0, min_delta: float = 0.5,
                 integer_chips: bool = False):
        self.sp = speedup
        self.B = float(B)
        self.realloc_cost = realloc_cost_s
        self.min_delta = min_delta
        self.integer_chips = integer_chips
        # device→host event-budget re-runs taken by simulate()
        self.device_fallbacks = 0

    # ---- per-job speedups (paper §7) ------------------------------------
    def _job_speedup(self, job: Job) -> Speedup:
        return self.sp if job.speedup is None else job.speedup

    def _stackable(self, job: Job) -> RegularSpeedup:
        """This job's speedup as a stackable (scalar RegularSpeedup) leaf;
        raises TypeError for one that cannot join the fleet's stack."""
        sp = self._job_speedup(job)
        if not isinstance(sp, RegularSpeedup):
            src = ("scheduler-wide speedup" if job.speedup is None
                   else "speedup")
            raise TypeError(
                f"job {job.name!r}: {src} {type(sp).__name__} cannot be "
                "stacked into a heterogeneous fleet — per-job planning "
                "needs regular-family members (fit one with "
                "core.hesrpt.fit_power, or give every job the same "
                "scheduler-wide function)")
        return sp

    @staticmethod
    def _is_hetero(fleets: list[list[Job]]) -> bool:
        return any(j.speedup is not None for fleet in fleets for j in fleet)

    def slot_speedup(self, jobs: list[Job]):
        """Per-slot stacked speedup aligned with ``jobs`` (or the shared
        function when no job carries its own)."""
        if not any(j.speedup is not None for j in jobs):
            return self.sp
        return stack_speedups([self._stackable(j) for j in jobs], B=self.B)

    # ---- planning -------------------------------------------------------
    def plan(self, jobs: list[Job]):
        """SmartFill plan for the active set (sorted internally).

        Returns (order, SmartFillSchedule) with ``order[r]`` the
        jobs-index occupying schedule row r.
        """
        orders, sched = self.plan_fleets([jobs])
        return orders[0], sched.instance(0)

    def _pack_fleets(self, fleets: list[list[Job]]):
        """Sort + pad fleets into the batched API's prefix-mask layout.

        Completed jobs (``done is not None``) are left out; ``orders[n]``
        holds the fleet indices of the planned jobs in row order — by
        normalized size (size / sᵢ(B), ties by weight) when any job
        carries its own speedup, by (−size, weight) otherwise.  In the
        heterogeneous case the per-job parameters come back as a
        ``StackedSpeedup`` with (N, M) leaves (padded slots
        edge-replicate the last live job's), else None.
        """
        from ..core.smartfill import normalized_order

        N = len(fleets)
        hetero = self._is_hetero(fleets)
        actives = [[i for i, j in enumerate(fleet) if j.done is None]
                   for fleet in fleets]
        M = max((len(a) for a in actives), default=0)
        X = np.zeros((N, M))
        W = np.zeros((N, M))
        act = np.zeros((N, M), dtype=bool)
        orders = []
        rows = []                       # per-fleet members in row order
        for n, (fleet, act_idx) in enumerate(zip(fleets, actives)):
            if hetero:
                # only planned jobs consult the scheduler-wide function as
                # their default
                members = {i: self._stackable(fleet[i]) for i in act_idx}
                if act_idx:
                    perm = normalized_order(
                        stack_speedups([members[i] for i in act_idx],
                                       B=self.B),
                        np.array([fleet[i].size for i in act_idx]),
                        np.array([fleet[i].weight for i in act_idx]),
                        self.B)
                    order = [act_idx[p] for p in perm]
                else:
                    order = []
                rows.append([members[i] for i in order])
            else:
                order = sorted(act_idx,
                               key=lambda i: (-fleet[i].size,
                                              fleet[i].weight))
            orders.append(order)
            for r, oi in enumerate(order):
                X[n, r] = fleet[oi].size
                W[n, r] = fleet[oi].weight
                act[n, r] = True
        sp_b = stack_speedup_rows(rows, M, self.B) if hetero else None
        return orders, X, W, act, sp_b

    def _plan_batched(self, X, W, act, sp=None):
        """One batched SmartFill solve — sharded when a fleet mesh is up.

        Inside a 1-D ``with FleetMesh(...)`` context the instance axis is
        split over the mesh by ``plan_sharded`` (the same bits);
        otherwise ``smartfill_batched`` runs on the speedup's device.
        ``sp`` overrides the scheduler-wide function (the heterogeneous
        packed ``StackedSpeedup``).
        """
        from ..distributed.fleet import active_fleet_mesh, plan_sharded

        sp = self.sp if sp is None else sp
        mesh = active_fleet_mesh()
        if mesh is not None:
            return plan_sharded(sp, X, W, B=self.B, active=act, mesh=mesh)
        return smartfill_batched(sp, X, W, B=self.B, active=act)

    def plan_fleets(self, fleets: list[list[Job]]):
        """SmartFill plans for many independent job sets in one call.

        Fleets are padded to the widest one; jobs carrying their own
        ``speedup`` make the whole batch heterogeneous.  Returns (orders,
        BatchedSmartFillSchedule) where orders[n][r] maps schedule row r
        back to fleets[n]'s job index.
        """
        orders, X, W, act, sp_b = self._pack_fleets(fleets)
        if X.shape[1] == 0:
            raise ValueError("plan_fleets: no active jobs in any fleet")
        return orders, self._plan_batched(X, W, act, sp_b)

    def current_allocations_fleets(self, fleets: list[list[Job]]):
        """Instantaneous optimal allocations for many fleets at once: one
        batched solve, one host read.  Returns per-fleet numpy vectors in
        each fleet's own job order (integerized when ``integer_chips``)."""
        orders, X, W, act, sp_b = self._pack_fleets(fleets)
        if X.shape[1] == 0:
            return [np.zeros(len(fleet)) for fleet in fleets]
        th = current_allocations_from(
            self._plan_batched(X, W, act, sp_b)).cpu().numpy()
        out = []
        for n, (fleet, order) in enumerate(zip(fleets, orders)):
            alloc = np.zeros(len(fleet))
            for r, oi in enumerate(order):
                alloc[oi] = th[n, r]
            if self.integer_chips:
                alloc = integerize(alloc, int(self.B)).astype(np.float64)
            out.append(alloc)
        return out

    def current_allocations(self, jobs: list[Job]) -> np.ndarray:
        """Instantaneous optimal allocations for the active jobs (the
        single-fleet view of ``current_allocations_fleets``)."""
        return self.current_allocations_fleets([jobs])[0]

    # ---- event loop -----------------------------------------------------
    def simulate(self, jobs: list[Job]) -> ClusterSimResult:
        """Run to completion: arrivals + completions + reallocation costs.

        Returns a ``ClusterSimResult`` (iterates as ``(events, J)``) with
        J = Σ wᵢ·(Tᵢ − arrivalᵢ).  With no cost configured
        (``realloc_cost_s == 0`` and continuous chips) the run is the
        paper's exact OPT execution on the device scenario engine
        (``simulate_policy_device``, arrivals folded in as events; no
        ``min_delta`` merging).  Otherwise the host loop
        (``simulate_host``) charges the penalties and integerizes chips.

        If the device engine does not finish every job within its 4n + 16
        event budget, the run is re-done on the host loop and flagged
        (``status="device-event-budget-exhausted"``, one warning a
        process, ``device_fallbacks`` counts them).
        """
        if self.realloc_cost == 0.0 and not self.integer_chips:
            return self._simulate_device(jobs)
        events, J = self.simulate_host(jobs)
        return ClusterSimResult(events=events, J=J, path="host")

    def _simulate_device(self, jobs: list[Job]) -> ClusterSimResult:
        """Exact OPT execution on the scenario engine (no cost model);
        per-job speedups ride in as job-indexed leaves and the policy is
        the re-planning heterogeneous SmartFill."""
        from .. import core
        from .policies import HeteroSmartFillPolicy, SmartFillPolicy

        n = len(jobs)
        if n == 0:
            return ClusterSimResult(events=[], J=0.0)
        # jobs already completed (done set) are padding: size 0
        x = np.array([0.0 if j.done is not None else j.size for j in jobs])
        w = np.array([j.weight for j in jobs])
        arr = np.array([j.arrival for j in jobs])
        if not (x > 0).any():
            return ClusterSimResult(events=[], J=0.0)
        sp = self.slot_speedup(jobs)
        policy = (SmartFillPolicy(sp, B=self.B) if sp is self.sp
                  else HeteroSmartFillPolicy(sp, B=self.B))
        res = core.simulate_policy_device(sp, x, w, policy, B=self.B,
                                          arrival=arr)
        if not np.isfinite(res.J):      # event budget exhausted
            self.device_fallbacks += 1
            global _warned_device_fallback
            if not _warned_device_fallback:
                _warned_device_fallback = True
                _log.warning(
                    "device scenario engine exhausted its %d-event budget "
                    "on a %d-job instance; re-running on the host loop "
                    "(flagged on ClusterSimResult.status; further "
                    "occurrences are counted, not logged)",
                    4 * n + 16, n)
            events, J = self.simulate_host(jobs)
            return ClusterSimResult(events=events, J=J, path="host",
                                    status="device-event-budget-exhausted")
        live = x > 0
        J = float(np.sum(np.where(live, w * (res.T - arr), 0.0)))
        # host-loop convention: jobs that entered already completed still
        # contribute their recorded flow time
        J += sum(j.weight * (j.done - j.arrival) for j in jobs
                 if j.done is not None)
        return ClusterSimResult(events=res.events, J=J)

    def simulate_host(self, jobs: list[Job]):
        """Host event loop with real-world costs.

        Each event plans with one ``current_allocations`` call and reads
        the rates sᵢ(θᵢ) of each job's own speedup (the per-slot stacked
        function) in float64 from the speedup's device; the merge, the
        penalties and the clock stay in numpy float64.
        """
        slot_sp = self.slot_speedup(jobs)
        jobs = [dataclasses.replace(j) for j in jobs]
        t = 0.0
        events = []
        pending = sorted([j for j in jobs if j.arrival > 0],
                         key=lambda j: j.arrival)
        last_alloc = np.zeros(len(jobs))

        for _ in range(8 * len(jobs) + 64):
            if all(j.done is not None for j in jobs):
                break
            theta = self.current_allocations(
                [j if (j.arrival <= t and j.done is None) else
                 dataclasses.replace(j, done=j.done if j.done is not None
                                     else -1.0)
                 for j in jobs])
            # merge small reallocation deltas (anti-thrash)
            if np.abs(theta - last_alloc).max() < self.min_delta:
                theta = last_alloc
            resized = np.abs(theta - last_alloc) > 1e-9
            # reallocation penalty: resized jobs lose realloc_cost of service
            penalty = np.where(resized & (theta > 0), self.realloc_cost, 0.0)
            last_alloc = theta
            rates = host_call(slot_sp, "s", theta)
            rates = np.broadcast_to(rates, theta.shape)
            for i, j in enumerate(jobs):
                j.allocated = theta[i]
            # next event: completion or arrival
            dts = [j.size / rates[i] + penalty[i]
                   for i, j in enumerate(jobs)
                   if j.arrival <= t and j.done is None and rates[i] > 0]
            dt_completion = min(dts) if dts else np.inf
            dt_arrival = (pending[0].arrival - t) if pending else np.inf
            dt = min(dt_completion, dt_arrival)
            if not np.isfinite(dt):
                break
            events.append((t, theta.copy()))
            # advance
            for i, j in enumerate(jobs):
                if j.arrival <= t and j.done is None and rates[i] > 0:
                    eff = max(dt - penalty[i], 0.0)
                    j.size = max(j.size - rates[i] * eff, 0.0)
            t += dt
            # pop every arrival at or before t: coincident arrivals and
            # accumulated-float drift must not leave a job pending.  Clamp
            # t up to the popped arrival so the activation checks
            # (j.arrival <= t) admit the job this round.
            while pending and pending[0].arrival <= t + 1e-12:
                t = max(t, pending[0].arrival)
                pending.pop(0)
            for j in jobs:
                if j.arrival <= t and j.done is None and j.size <= 1e-9:
                    j.done = t
        J = sum(j.weight * (j.done - j.arrival) for j in jobs
                if j.done is not None)
        return events, J
