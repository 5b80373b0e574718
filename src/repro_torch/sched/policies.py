"""Policy zoo for the scenario engine — batch-first allocators.

Every policy is a frozen dataclass implementing one interface,

    policy(rem, w, active, B=None) → allocations θ with Σ over active ≤ B,

where ``rem``, ``w`` and ``active`` are (K, M): K workloads of M job
slots, all advanced by one engine event at once (``core/simulator.py``).
A 1-D (M,) call is one workload.  The optional 4th argument is the
*current* budget under fault-aware execution: ``None`` (the default, and
the only form the unfaulted engine uses) means "spend your own ``B``";
a scalar or (K,) B(t) overrides it for this event, so re-planning
policies re-solve under the live budget and cached plans
(``HeteroSmartFillPolicy.pinned(cache_plan=True)``) invalidate and
re-solve instead of executing a stale table.

The numeric fields named in a policy's ``LEAVES`` — the speedup, B,
heSRPT's exponent, static constants — may carry a leading (K,) workload
dimension (per-workload budgets, fitted exponents) or a job dimension;
structural knobs (grid sizes, the resolved fast-path flag) are plain
attributes.  ``bind(device, dtype)`` turns the leaves into tensors once
per run, as the engine does.  The budget a policy spends is **its own
``B``** — the engine executes whatever the policy allocates.

The zoo covers the paper's §6 comparison set:

  * ``SmartFillPolicy`` — re-plans the OPT solution (Algorithm 2) on the
    remaining sizes at every event; by Prop. 7 this reproduces the
    one-shot schedule exactly (time consistency).
  * ``HeSRPTPolicy``  — Berg et al.'s closed form for s = aθ^p, applied
    under any true speedup.
  * ``EquiPolicy``    — EQUI: B/m to each active job.
  * ``SRPT1Policy``   — single-server SRPT: everything to the smallest
    remaining job (the p → 1 limit of heSRPT).
  * ``GWFStaticPolicy`` — water-fills with *static* derivative-ratio
    constants (default: proportional to weights) each event.

Heterogeneous fleets (paper §7) add two members:

  * ``HeteroSmartFillPolicy`` — re-planning SmartFill for *per-job*
    speedup functions, re-ranking by normalized remaining size each
    event, or executing a pinned one-shot order (``pinned``).
  * ``WeightedMarginalRatePolicy`` — the retired pre-§7 heuristic, kept
    as a named baseline: equalize (w_i/rem_i)·s_i'(θ_i) over the active
    jobs by water-filling with static constants c_i ∝ rem_i/w_i.

``ClassSmartFillPolicy`` is heteroSF over class aggregates
(``core/classes.py``), the policy of ``simulate_fluid_classes``.

The streaming control plane (``serve/stream.py``) replans through the
host-side ``StreamingSmartFillPolicy`` (carried order and λ payload,
warm or cold) or through ``stream_replan_core``, the per-event cascade
(fresh solve → certificate → exchange search → ladder) that the device
event loop calls and ``StreamCascadePolicy`` mirrors on the host loop.

SmartFill and heteroSF call the batch-first SmartFill core once per
event for all K workloads.  GWF-static and WMR call the batched CAP
front door ``solve_cap_batched(impl="auto")`` where the reference takes
the closed form or the sorted per-job solver: in float64 those solvers,
in float32 on the card the CUDA waterfill kernels (``core/gwf.py::
auto_impl``).

All policies tolerate padded jobs (``active`` False ⇒ θ = 0) and an
empty active set (θ ≡ 0), which the engine's halt steps rely on.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import as_tensor, resolve_device, vpow
from ..core.classes import aggregate_classes, plan_classes
from ..core.gwf import solve_cap_batched
from ..core.simulator import lane_budget
from ..core.smartfill import (WarmStart, _fast_ok, _host, _is_pure_power,
                              _on, _permute_speedup, _solve)
from ..core.speedup import (RegularSpeedup, Speedup, StackedSpeedup,
                            collapse_homogeneous, host_call, inner_per_job,
                            is_per_job, map_leaves, per_instance)

__all__ = [
    "Policy",
    "SmartFillPolicy",
    "HeteroSmartFillPolicy",
    "ClassSmartFillPolicy",
    "StreamingSmartFillPolicy",
    "StreamCascadePolicy",
    "StreamPlan",
    "stream_replan_core",
    "HeSRPTPolicy",
    "EquiPolicy",
    "SRPT1Policy",
    "GWFStaticPolicy",
    "WeightedMarginalRatePolicy",
    "default_zoo",
]

_TINY = 1e-300


def _lexsort(minor, major):
    """``jnp.lexsort((minor, major))`` along the last axis: order by
    ``major``, ties by ``minor``, remaining ties by index (two stable
    sorts)."""
    i1 = torch.argsort(minor, dim=-1, stable=True)
    i2 = torch.argsort(major.gather(-1, i1), dim=-1, stable=True)
    return i1.gather(-1, i2)


def _active_order(rem, w, active):
    """Permutation putting active jobs first, sorted the SmartFill way:
    remaining size non-increasing, ties by weight non-decreasing."""
    return _lexsort(w, torch.where(active, -rem, torch.inf))


def _per_lane(v, K: int):
    """A leaf broadcast against (K, M): (K,) per-workload leaves become
    (K, 1); scalars, (K, 1) and job-indexed leaves stay."""
    return v[:, None] if (v.ndim == 1 and v.shape[0] == K) else v


def _column(theta, m):
    """Column m−1 of each workload's (M, M) plan: the allocation of the
    current phase, zero past the m live rows."""
    K, M = theta.shape[:2]
    col = torch.clamp(m - 1, 0, M - 1)
    th = theta.gather(2, col[:, None, None].expand(K, M, 1))[..., 0]
    idx = torch.arange(M, device=theta.device)
    return torch.where(idx[None, :] < m[:, None], th, 0.0)


def _scatter(rem, order, col, active):
    """Rows in ``order`` coordinates back to the job slots."""
    out = torch.zeros_like(rem).scatter(1, order, col)
    return torch.where(active, out, 0.0)


def _permute_jobs(sp, order, K: int):
    """``sp`` with its job-indexed leaves taken in ``order`` (K, M);
    per-workload (K,) and shared scalar leaves stay."""
    def take(l):
        if l.ndim == 2 and l.shape == order.shape:
            return l.gather(1, order)
        if l.ndim == 1 and l.shape[0] != K:
            return l[order]           # shared per-job → per-workload copies
        return l
    return map_leaves(sp, take)


class Policy:
    """Marker base: the engine dispatches on ``device_ready``."""

    device_ready = True
    name = "policy"
    LEAVES: tuple = ("B",)

    def __call__(self, rem, w, active, B=None):
        """Allocations for (K, M) (or one (M,)) workload state."""
        rem, w, active, b, one = self._state(rem, w, active, B)
        th = self._allocate(rem, w, active, b, moved=B is not None)
        return th[0] if one else th

    def _state(self, rem, w, active, B):
        """The call's state as (K, M) tensors on one device, its (K,)
        budget, and whether it was one (M,) workload."""
        if isinstance(rem, torch.Tensor):
            dev = rem.device
        else:
            dev = resolve_device(None, *self._tensor_leaves())
        rem = as_tensor(rem, dev)
        w = as_tensor(w, dev, rem.dtype)
        active = as_tensor(active, dev, torch.bool)
        one = rem.ndim == 1
        if one:
            rem, w, active = rem[None], w[None], active[None]
        b = lane_budget(self.B if B is None else B, rem.shape[0], rem)
        return rem, w, active, b, one

    def _allocate(self, rem, w, active, b, moved):
        raise NotImplementedError

    def _tensor_leaves(self):
        found = []
        self.map_leaves(lambda v: found.append(v) or v)
        return [v for v in found if isinstance(v, torch.Tensor)]

    def map_leaves(self, fn):
        """A copy with ``fn`` applied to every numeric leaf: the values
        named in ``LEAVES`` (scalars, arrays, tensors), the leaves of a
        speedup among them, and those of nested policies (a ladder's
        rungs, a wrapped policy), in one fixed order."""
        new = {name: _map_value(getattr(self, name), fn)
               for name in self.LEAVES if getattr(self, name) is not None}
        return dataclasses.replace(self, **new)

    def _leaf(self, name, like):
        """Leaf ``name`` as a tensor in ``like``'s dtype and device."""
        return as_tensor(getattr(self, name), like.device, like.dtype)

    def _sp(self, like):
        return map_leaves(self.sp, lambda l: l.to(device=like.device,
                                                  dtype=like.dtype))

    def bind(self, device, dtype=torch.float64):
        """A copy whose numeric leaves are ``dtype`` tensors on ``device``
        (speedup leaves and nested policies included)."""
        dev = torch.device(device)
        return self.map_leaves(lambda v: as_tensor(v, dev, dtype))


def _map_value(v, fn):
    """``fn`` over the numeric leaves of one ``LEAVES`` value."""
    if isinstance(v, Policy):
        return v.map_leaves(fn)
    if isinstance(v, tuple):
        return tuple(_map_value(x, fn) for x in v)
    if isinstance(v, Speedup):
        return map_leaves(v, fn)
    return fn(v)


@dataclasses.dataclass(frozen=True)
class EquiPolicy(Policy):
    """EQUI: split B evenly over the active jobs."""

    B: float
    name = "EQUI"

    def _allocate(self, rem, w, active, b, moved):
        m = active.sum(-1)
        share = b / torch.clamp_min(m, 1)
        return torch.where(active, share[:, None], 0.0)


@dataclasses.dataclass(frozen=True)
class SRPT1Policy(Policy):
    """SRPT-1: the whole budget to the smallest remaining active job."""

    B: float
    name = "SRPT-1"

    def _allocate(self, rem, w, active, b, moved):
        # argmin returns the first minimum, as the reference's does
        i = torch.argmin(torch.where(active, rem, torch.inf), -1)
        out = torch.zeros_like(rem).scatter(1, i[:, None], b[:, None])
        return torch.where(active, out, 0.0)


@dataclasses.dataclass(frozen=True)
class HeSRPTPolicy(Policy):
    """Berg et al. closed form: θ_i/B = (W_i^m − W_{i−1}^m)/W_k^m,
    m = 1/(1−p), over active jobs ranked by remaining size (desc)."""

    p: float
    B: float
    name = "heSRPT"
    LEAVES = ("p", "B")

    def _allocate(self, rem, w, active, b, moved):
        K, M = rem.shape
        order = _active_order(rem, w, active)
        ws = torch.where(active, w, 0.0).gather(1, order)
        # shares depend only on weight *ratios* — normalize per workload
        # so the cumsum powers cannot underflow
        ws = ws / torch.clamp_min(ws.amax(-1, keepdim=True), _TINY)
        m = active.sum(-1)
        mexp = 1.0 / (1.0 - _per_lane(self._leaf("p", rem), K))
        Wm = vpow(torch.clamp_min(torch.cumsum(ws, -1), 0.0), mexp)
        Wm_prev = torch.cat([torch.zeros_like(Wm[:, :1]), Wm[:, :-1]], -1)
        Wk = Wm.gather(1, torch.clamp_min(m - 1, 0)[:, None])
        shares = b[:, None] * (Wm - Wm_prev) / torch.clamp_min(Wk, _TINY)
        idx = torch.arange(M, device=rem.device)
        shares = torch.where(idx[None, :] < m[:, None], shares, 0.0)
        return _scatter(rem, order, shares, active)


@dataclasses.dataclass(frozen=True)
class SmartFillPolicy(Policy):
    """Re-planning SmartFill: the optimal allocation for the current
    remaining sizes — column m−1 of Algorithm 2 run on (rem, w).

    ``fast`` (the closed-form μ* of the pure-power family) is resolved
    at construction, where the speedup's parameters are read once.
    """

    sp: Speedup
    B: float
    coarse: int = 32
    descent_iters: int = 40
    cap_iters: int = 64
    fast: bool | None = None
    name = "SmartFill"
    LEAVES = ("sp", "B")

    def __post_init__(self):
        if self.fast is None:
            object.__setattr__(self, "fast", _is_pure_power(self.sp))

    def _allocate(self, rem, w, active, b, moved):
        K, M = rem.shape
        sp = self._sp(rem)
        order = _active_order(rem, w, active)
        xs = torch.where(active, rem, 0.0).gather(1, order)
        ws = torch.where(active, w, 0.0).gather(1, order)
        m = active.sum(-1)
        # job-indexed leaves invalidate the shared-exponent closed form
        # (use HeteroSmartFillPolicy for those — this guard just makes
        # the mistake safe)
        fast = bool(self.fast) and not inner_per_job(sp, K)
        theta = _solve(sp, xs, ws, b, m, self.coarse, self.descent_iters,
                       self.cap_iters, fast, with_times=False)[0]
        return _scatter(rem, order, _column(theta, m), active)


def _cap_impl(sp, K: int, per_job_sorted: bool) -> dict:
    """The CAP solver the reference picks, as ``solve_cap_batched``
    arguments: ``impl="auto"`` (the closed form or the sorted per-job
    solver in float64, the CUDA kernels in float32 on the card) for a
    shared RegularSpeedup, or with ``per_job_sorted`` for a per-job
    regular family; the 96-step λ-bisection otherwise."""
    per_job = inner_per_job(sp, K)
    if per_job_sorted:
        auto = per_job and isinstance(sp, (RegularSpeedup, StackedSpeedup))
    else:
        auto = isinstance(sp, RegularSpeedup) and not per_job
    return {"impl": "auto"} if auto else {"impl": "bisect", "iters": 96}


@dataclasses.dataclass(frozen=True)
class GWFStaticPolicy(Policy):
    """Water-fill with static CDR constants (default c ∝ w) each event.

    Solves the CAP (Algorithm 1) for the active set with constants that
    never adapt — the baseline isolating what SmartFill's carried
    constants c_k (Cor. 2.1) buy over naive weighted water-filling.
    """

    sp: Speedup
    B: float
    c: torch.Tensor | None = None   # per-job constants; None ⇒ w-derived
    name = "GWF-static"
    LEAVES = ("sp", "c", "B")

    def _allocate(self, rem, w, active, b, moved):
        K, M = rem.shape
        if self.c is None:
            wmax = torch.where(active, w, 0.0).amax(-1, keepdim=True)
            c = torch.where(active, w, 1.0) / torch.clamp_min(wmax, _TINY)
        else:
            c = _per_lane(self._leaf("c", rem), K).expand(K, M)
        c = torch.clamp_min(c, 1e-12)
        sp = self._sp(rem)
        th = solve_cap_batched(sp, b, c, active,
                               **_cap_impl(sp, K, per_job_sorted=False))
        return torch.where(active, th, 0.0)


@dataclasses.dataclass(frozen=True)
class HeteroSmartFillPolicy(Policy):
    """Re-planning SmartFill for per-job speedup functions (paper §7).

    ``sp`` carries job-indexed leaves aligned with the engine's job
    slots ((M,), or (K, M) per workload).  With a **pinned completion
    order** (``rank`` set — see ``pinned``) the active jobs are ranked
    by their one-shot rank at every event and only the *allocations*
    are re-solved; by Prop. 7 carried into §7 this executes the one-shot
    plan exactly (time consistency).  With ``rank=None`` the policy
    re-ranks every event by normalized remaining size rem_i / s_i(B).
    With a shared speedup this is exactly ``SmartFillPolicy``'s ranking
    and solve.  The closed-form μ* never applies (per-job exponents).

    ``pinned(..., cache_plan=True)`` also stores the one-shot allocation
    table Θ, making each event an O(M) lookup.  Under dynamic budgets
    the table executes verbatim on every workload whose B(t) equals the
    construction budget; when any workload's budget has moved, the
    moved ones re-solve on the pinned order (one batched solve, read
    only where the budget moved).  ``precise=False`` swaps the
    re-solve onto the relaxed grid/descent path.
    """

    sp: Speedup
    B: float
    rank: torch.Tensor | None = None    # per-job one-shot rank, or None
    theta: torch.Tensor | None = None   # cached (M, M) plan in rank coords
    coarse: int = 32
    descent_iters: int = 40
    cap_iters: int = 64
    precise: bool = True
    name = "heteroSF"
    LEAVES = ("sp", "B", "rank", "theta")

    @classmethod
    def pinned(cls, sp: Speedup, x0, w0, B: float | None = None,
               order=None, exchange_passes: int = 2,
               cache_plan: bool = False, **kwargs):
        """Policy with the one-shot completion order fixed at construction.

        ``x0``/``w0`` are the *initial* sizes/weights — (M,) for one
        instance or (K, M) for an ensemble.  For a single instance the
        order comes from the full planner (exchange search included);
        for a batch, from the per-instance normalized-size heuristic
        (the batched planner's order).  Pass ``order`` to pin a chosen
        permutation instead.

        ``cache_plan=True`` also stores the one-shot allocation table Θ
        and executes it by active-count lookup instead of re-solving —
        the engine's analog of ``simulator.schedule_policy``.  Only valid
        without arrivals (an arrival makes the active set a non-prefix
        of the pinned order — use rank-only pinning there).  The plans
        run on the device of ``sp``'s leaves.
        """
        from ..core.batch import smartfill_hetero_batched
        from ..core.smartfill import smartfill_hetero

        B = float(sp.B if B is None else B)
        x0 = _host(x0)
        w0 = _host(w0)
        if cache_plan and order is not None:
            raise ValueError("cache_plan plans its own order; pass one of "
                             "order / cache_plan")
        theta = None
        if x0.ndim == 1:
            if order is None:
                plan = smartfill_hetero(sp, x0, w0, B=B,
                                        exchange_passes=exchange_passes)
                order = plan.order
                if cache_plan:
                    theta = plan.theta
            order2d = np.atleast_2d(np.asarray(order))
        else:
            if order is None:
                order, sched = smartfill_hetero_batched(sp, x0, w0, B=B)
                if cache_plan:
                    theta = sched.theta
            order2d = np.asarray(order)
        rank = np.empty_like(order2d)
        np.put_along_axis(rank, order2d,
                          np.broadcast_to(np.arange(order2d.shape[1]),
                                          order2d.shape), axis=1)
        dev = resolve_device(None, sp)
        rank = as_tensor((rank if x0.ndim > 1 else rank[0]).astype(np.float64),
                         dev)
        return cls(sp=sp, B=B, rank=rank, theta=theta, **kwargs)

    def _allocate(self, rem, w, active, b, moved):
        K, M = rem.shape
        sp = self._sp(rem)
        if self.rank is None:
            b0 = lane_budget(self.B, K, rem)[:, None].expand(K, M)
            rate = per_instance(sp, K, 1).s(b0)
            key = torch.where(active, -(rem / torch.clamp_min(rate, _TINY)),
                              torch.inf)
        else:
            key = torch.where(active, self._leaf("rank", rem), torch.inf)
        order = _lexsort(w, key)
        m = active.sum(-1)

        def resolve(bv):
            xs = torch.where(active, rem, 0.0).gather(1, order)
            ws = torch.where(active, w, 0.0).gather(1, order)
            return _solve(_permute_jobs(sp, order, K), xs, ws, bv, m,
                          self.coarse, self.descent_iters, self.cap_iters,
                          False, precise=self.precise, with_times=False)[0]

        if self.theta is None:
            theta = resolve(b)
        else:
            # cached-plan execution: position r < m holds the active job
            # of r-th smallest pinned rank, which under pure completions
            # is exactly rank r — row r, column m−1 of the stored table
            theta = self._leaf("theta", rem).expand(K, M, M)
            if moved:
                # dynamic budget: the table was solved under self.B —
                # execute it verbatim where B(t) matches, re-solve on
                # the pinned order where it moved (one host sync); a
                # workload with no active job allocates 0 either way
                off = (b != lane_budget(self.B, K, rem)) & active.any(-1)
                if bool(off.any()):
                    theta = torch.where(off[:, None, None], resolve(b),
                                        theta)
        return _scatter(rem, order, _column(theta, m), active)


@dataclasses.dataclass(frozen=True)
class ClassSmartFillPolicy(HeteroSmartFillPolicy):
    """Re-planning SmartFill over *class aggregates* (``core/classes.py``).

    The state is aggregate: rem_c is the remaining class work R_c
    (initially n_c·x_c), w_c the aggregate weight n_c·w_c, under the
    aggregated speedup S_c(Θ) = n_c·s_c(Θ/n_c), which stays in the
    regular family (``class_speedup``), so the §7 per-job machinery
    applies with C rows instead of M.  Only construction differs from
    ``HeteroSmartFillPolicy``: ``from_classes`` applies the aggregation
    transform on the host and, by default, pins the class completion
    order of the one-shot ``plan_classes`` plan, so running it through
    ``simulate_fluid_classes`` executes the plan (Prop. 7 over
    aggregates).  ``pin=False`` keeps the per-event re-ranking ablation.
    Zero-count classes carry R = 0 and are never active.
    """

    name = "classSF"

    @classmethod
    def from_classes(cls, state, B: float | None = None, pin: bool = True,
                     cache_plan: bool = False, **kwargs):
        """Build from a ``ClassState``.

        ``pin=True`` ranks the classes by the one-shot plan's completion
        order (empty classes rank last: they are never active);
        ``cache_plan=True`` also stores the plan's allocation table for
        a lookup an event instead of a re-solve.  The plan runs on the
        device of the state's speedup.
        """
        B = float(state.B if B is None else B)
        plan = plan_classes(state, B=B) if (pin or cache_plan) else None
        return cls._from_plan(state, plan, B, cache_plan, **kwargs)

    @classmethod
    def _from_plan(cls, state, plan, B: float | None = None,
                   cache_plan: bool = False, **kwargs):
        """``from_classes`` on a plan already made for ``state`` at
        ``B`` (None: the re-ranking policy)."""
        B = float(state.B if B is None else B)
        sp_agg, _, _ = aggregate_classes(state)
        dev = sp_agg.device
        rank = theta = None
        if plan is not None:
            C = state.C
            r = np.full(C, C, dtype=np.float64)
            r[np.asarray(plan.order)] = np.arange(plan.order.size)
            rank = as_tensor(r, dev)
            if cache_plan:
                kl = plan.order.size
                theta = torch.zeros((C, C), dtype=torch.float64, device=dev)
                if kl:
                    theta[:kl, :kl] = plan.sched.theta.to(dev)
        return cls(sp=sp_agg, B=B, rank=rank, theta=theta, **kwargs)


@dataclasses.dataclass(frozen=True)
class WeightedMarginalRatePolicy(Policy):
    """Retired heterogeneity heuristic (named baseline, cf. §7).

    A GWF with static constants c_i ∝ rem_i/w_i evaluated under each
    job's own s_i — no carried CDR constants, no μ* recursion, no order
    search.  Per-job regular families take the sorted-bracket per-job
    CAP (the CUDA ``hetero_waterfill`` kernel in float32 on the card),
    anything else the λ-bisection.
    """

    sp: Speedup
    B: float
    name = "WMR"
    LEAVES = ("sp", "B")

    def _allocate(self, rem, w, active, b, moved):
        K, M = rem.shape
        c = torch.where(active, rem / torch.clamp_min(w, _TINY), 1.0)
        cmax = torch.where(active, c, 0.0).amax(-1, keepdim=True)
        c = torch.clamp_min(c / torch.clamp_min(cmax, _TINY), 1e-12)
        sp = self._sp(rem)
        th = solve_cap_batched(sp, b, c, active,
                               **_cap_impl(sp, K, per_job_sorted=True))
        return torch.where(active, th, 0.0)


def default_zoo(sp: Speedup, B: float | None = None,
                p_fit: float = 0.5) -> tuple:
    """The paper's §6 comparison set for one server model.

    ``p_fit`` is the power-law exponent heSRPT plans with (for pure-power
    speedups pass the true p; otherwise a ``fit_power`` fit).
    """
    B = float(sp.B if B is None else B)
    return (
        SmartFillPolicy(sp, B=B),
        HeSRPTPolicy(p=p_fit, B=B),
        EquiPolicy(B=B),
        SRPT1Policy(B=B),
        GWFStaticPolicy(sp, B=B),
    )


# ---------------------------------------------------------------------------
# Streaming replanning (serve/stream.py): the host-side incremental
# re-planner, and the per-event cascade the device event loop runs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StreamPlan:
    """One replanning event's output.

    order: (m,) controller-slot indices — schedule row r executes the
      job in slot ``order[r]`` (row coords: remaining size
      non-increasing, so row m−1 completes first).
    table: (M, M) allocation table in row coords (column j = the phase
      with rows 0..j active), a tensor on the planner's device, executed
      by active-count lookup exactly like
      ``HeteroSmartFillPolicy.pinned(cache_plan=True)``.
    J / J_linear: the solve's executed objective and value-function
      claim Σ a_i x_i; ``certified`` is the J == J_linear realized-order
      certificate (Prop. 9 / §7).
    warm: True when the plan came from the warm-start path (carried
      completion order + validated λ hints) rather than a cold solve.
    """

    order: np.ndarray
    table: torch.Tensor
    J: float
    J_linear: float
    m: int
    B: float
    warm: bool
    certified: bool

    def slot_allocations(self) -> np.ndarray:
        """(M,) current-phase allocations scattered back to slot coords."""
        M = int(self.table.shape[0])
        out = np.zeros(M)
        if self.m:
            col = _host(self.table)[:, min(self.m - 1, M - 1)]
            out[self.order] = col[:self.m]
        return out


class StreamingSmartFillPolicy(Policy):
    """Host-side incremental re-planner for the streaming control plane.

    Carries warm-start state *across* replanning events (the open-arrival
    loop of ``serve/stream.py``): the previous plan's completion order
    and its λ payload (per-iteration CAP duals + the generic-path
    λ-bracket, ``core.smartfill.WarmStart``).  Between consecutive
    events the live set changes by one arrival or completion, so

      * the **order** is maintained incrementally — completed slots drop
        out, arrivals binary-insert by normalized remaining size
        rem_i / s_i(B).  This is sound between events because CAP
        allocations are non-decreasing along schedule rows (θ_1 ≤ … ≤
        θ_m), so remaining sizes never cross during execution; and

      * the **λ payload** seeds the next solve's searches.  Both halves
        are validated on use (β-probes, ``core.gwf.cap_bracket_probe``
        semantics), so a stale payload costs cold pricing, never a wrong
        answer.

    Every warm plan is accepted only under the ``J == J_linear``
    realized-order certificate; a failed certificate (or non-finite
    solve) falls back to a **cold** plan — a from-scratch re-rank, plus
    the full §7 exchange-order search for per-job speedups.  A cold plan
    that *still* fails certification is returned uncertified; the
    streaming controller then falls down the robust degradation ladder
    instead of executing it.

    Not an engine policy (``device_ready=False``): replanning is a
    host-side control-plane step between execution windows, with mutable
    warm state.  The solves run on ``device`` (default: the device of
    ``sp``'s leaves, else CUDA) in float64.  ``plan`` is the real
    interface; ``__call__`` adapts it to the host-policy signature.
    """

    device_ready = False
    name = "streamingSF"

    def __init__(self, sp: Speedup, B: float | None = None, *,
                 certificate_rtol: float = 1e-8, coarse: int = 32,
                 descent_iters: int = 40, cap_iters: int = 64,
                 exchange_passes: int = 2, exchange_window: int = 1,
                 stol_rel: float | None = None, device=None):
        self.device = resolve_device(device, sp)
        self.sp = collapse_homogeneous(_on(sp, self.device, torch.float64))
        self.B = float(sp.B if B is None else B)
        self.certificate_rtol = float(certificate_rtol)
        self.coarse = int(coarse)
        self.descent_iters = int(descent_iters)
        self.cap_iters = int(cap_iters)
        self.exchange_passes = int(exchange_passes)
        self.exchange_window = int(exchange_window)
        self.stol_rel = stol_rel
        self._per_job = is_per_job(self.sp)
        self._fast = _fast_ok(self.sp)
        self.reset()

    def reset(self) -> None:
        """Drop all carried warm state (and the replan counters)."""
        self.warm: WarmStart | None = None
        self._order = np.zeros(0, np.int64)
        self.warm_replans = 0
        self.cold_replans = 0
        self.order_searches = 0

    # -- internals --------------------------------------------------------

    def _solo_key(self, rem: np.ndarray) -> np.ndarray:
        """Normalized remaining size rem_i / s_i(B) per slot (the §7
        SJF ranking key; shared speedups broadcast)."""
        M = rem.shape[0]
        rate = np.broadcast_to(host_call(self.sp, "s", np.full(M, self.B)),
                               (M,))
        return rem / np.maximum(rate, _TINY)

    def release(self, slots) -> None:
        """Forget carried state for recycled slots.

        The controller calls this when a job leaves its slot (completion
        or eviction).  Without it a new occupant of the same slot would
        inherit the old job's position in the carried order — the merged
        order silently stops being the SJF order and warm plans drift
        from cold ones.
        """
        slots = np.atleast_1d(np.asarray(slots, np.int64))
        if self._order.size:
            self._order = self._order[~np.isin(self._order, slots)]

    def _merge_order(self, rem, w, act) -> np.ndarray:
        """Warm order: drop completed slots from the carried order and
        binary-insert arrivals by normalized size (no re-sort of the
        survivors — that is the whole point)."""
        keep = self._order[act[self._order]]
        new = np.setdiff1d(np.where(act)[0], keep)
        if new.size:
            key = self._solo_key(rem)
            new = new[np.argsort(-key[new], kind="stable")]
            # survivor keys are non-increasing along the carried order
            # (allocations non-decreasing along rows ⇒ sizes never
            # cross); searchsorted wants ascending, hence the negation
            pos = np.searchsorted(-key[keep], -key[new], side="right")
            keep = np.insert(keep, pos, new)
        return keep

    def _fresh_order(self, rem, w, act) -> np.ndarray:
        slots = np.where(act)[0]
        key = self._solo_key(rem)
        return slots[np.lexsort((w[slots], -key[slots]))]

    def _run(self, order, rem, w, Bv, m, lam0=None, bracket0=None):
        """Padded one-instance ``_solve`` on the given slot order (row
        coords, m live rows); returns ``_solve``'s outputs for the row."""
        M = rem.shape[0]
        dev = self.device
        rest = np.setdiff1d(np.arange(M), order)
        full = np.concatenate([order, rest]).astype(np.int64)
        live = np.arange(M) < m
        xs = as_tensor(np.where(live, rem[full], 0.0), dev)[None]
        ws = as_tensor(np.where(live, w[full], 0.0), dev)[None]
        sp_o = _permute_speedup(self.sp, full) if self._per_job else self.sp
        kw = {}
        if lam0 is not None:
            kw["lam0"] = as_tensor(lam0, dev, xs.dtype)[None]
        if bracket0 is not None:
            kw["bracket0"] = as_tensor(bracket0, dev, xs.dtype)[None]
        out = _solve(sp_o, xs, ws,
                     torch.full((1,), Bv, dtype=xs.dtype, device=dev),
                     torch.full((1,), m, device=dev), self.coarse,
                     self.descent_iters, self.cap_iters, self._fast,
                     stol_rel=self.stol_rel, **kw)
        return tuple(o[0] for o in out)

    def _certified(self, J, J_lin) -> bool:
        # floor the tolerance at the solve dtype's precision: the 1e-8
        # default is meaningful in float64 but unreachable in float32
        eps = float(torch.finfo(J.dtype).eps)
        rtol = max(self.certificate_rtol, 64.0 * eps)
        J = float(J)
        J_lin = float(J_lin)
        if not (np.isfinite(J) and np.isfinite(J_lin)):
            return False
        return abs(J - J_lin) <= rtol * max(1.0, abs(J_lin))

    def _search_order(self, rem, w, act, Bv) -> np.ndarray:
        """Full §7 exchange-order search on the dense active set."""
        from ..core.smartfill import smartfill_hetero

        slots = np.where(act)[0]
        sp_sub = (_permute_speedup(self.sp, slots) if self._per_job
                  else self.sp)
        plan = smartfill_hetero(
            sp_sub, rem[slots], w[slots], B=Bv,
            coarse=self.coarse, descent_iters=self.descent_iters,
            cap_iters=self.cap_iters,
            exchange_passes=self.exchange_passes,
            exchange_window=self.exchange_window, stol_rel=self.stol_rel,
            device=self.device)
        self.order_searches += 1
        return slots[np.asarray(plan.order)]

    # -- interface --------------------------------------------------------

    def plan(self, rem, w, active=None, B=None,
             warm: bool = True) -> StreamPlan:
        """Replan the live set; warm-start when possible.

        rem/w are (M,) slot-coordinate state (M = the controller's slot
        capacity); ``active`` masks the live slots (zero-remaining slots
        are dropped regardless).  ``B`` is the live budget.
        ``warm=False`` forces the cold from-scratch path (the benchmark
        baseline).  Updates the carried warm state either way.
        """
        rem = _host(rem)
        w = _host(w)
        M = rem.shape[0]
        act = (np.ones(M, bool) if active is None
               else np.asarray(active, bool)) & (rem > 0)
        Bv = float(self.B if B is None else B)
        m = int(act.sum())
        if m == 0:
            return StreamPlan(order=np.zeros(0, np.int64),
                              table=torch.zeros((M, M), dtype=torch.float64,
                                                device=self.device),
                              J=0.0, J_linear=0.0, m=0, B=Bv, warm=False,
                              certified=True)

        picked = None
        if warm and self.warm is not None and self._order.size:
            order = self._merge_order(rem, w, act)
            out = self._run(order, rem, w, Bv, m,
                            lam0=self.warm.lam, bracket0=self.warm.bracket)
            if self._certified(out[5], out[6]):
                self.warm_replans += 1
                picked = (order, out, True)
        if picked is None:
            # cold: from scratch, no carried state — a fresh normalized-
            # size ranking, escalating to the §7 exchange-order search
            # when jobs carry their own speedups or the certificate
            # rejects the ranking (non-agreeable weights: the order is
            # a decision, and a cold replan must re-make it)
            if self._per_job and m > 1:
                order = self._search_order(rem, w, act, Bv)
                out = self._run(order, rem, w, Bv, m)
            else:
                order = self._fresh_order(rem, w, act)
                out = self._run(order, rem, w, Bv, m)
                if m > 1 and not self._certified(out[5], out[6]):
                    order = self._search_order(rem, w, act, Bv)
                    out = self._run(order, rem, w, Bv, m)
            self.cold_replans += 1
            picked = (order, out, False)

        order, out, was_warm = picked
        self.warm = WarmStart(lam=out[7], bracket=out[8])
        self._order = np.asarray(order, np.int64)
        return StreamPlan(order=self._order, table=out[0],
                          J=float(out[5]), J_linear=float(out[6]), m=m,
                          B=Bv, warm=was_warm,
                          certified=self._certified(out[5], out[6]))

    def __call__(self, rem, w, active, B=None):
        """Host-policy adapter: the current-phase allocation column."""
        return as_tensor(self.plan(rem, w, active, B=B).slot_allocations(),
                         self.device)


class HostReads:
    """A read of device flags to the host, counted.

    The cascade and the device event loop take their branches on the
    host; each read syncs the host to the device on a card.  Passing a
    ``HostReads`` as ``read=`` counts them (``n``).
    """

    def __init__(self):
        self.n = 0

    def __call__(self, flags):
        self.n += 1
        return flags.tolist()


def _stream_certified(J, J_lin, certificate_rtol, dtype):
    """The J == J_linear realized-order certificate (Prop. 9) as a device
    flag, floored at the dtype's precision like the host ``_certified``."""
    rt = max(float(certificate_rtol), 64.0 * torch.finfo(dtype).eps)
    return (torch.isfinite(J) & torch.isfinite(J_lin)
            & (torch.abs(J - J_lin)
               <= rt * torch.clamp_min(torch.abs(J_lin), 1.0)))


def _exchange_search_shared(run_orders, order0, out0, m, max_steps, read):
    """Steepest-descent adjacent-exchange order search (shared speedups).

    Starts from a failed fresh order, scores all M−1 adjacent swaps
    with one batched solve per step (``run_orders`` over (M−1, M)
    orders), and takes the best strictly-improving swap until none
    improves (or ``max_steps``): one host read a step.  The
    shared-speedup analogue of the §7 host search the streaming policy
    escalates to (non-agreeable live weights: rem shrinks while w stays
    1/x₀, so the order is a decision the certificate audits).
    """
    M = order0.shape[0]
    ci = torch.arange(M - 1, device=order0.device)
    J0 = out0[5]
    bestJ = torch.where(torch.isfinite(J0), J0, torch.inf)
    order, out = order0, out0
    for _ in range(int(max_steps)):
        orders = order.expand(M - 1, M).clone()
        orders[ci, ci] = order[ci + 1]
        orders[ci, ci + 1] = order[ci]
        outs = run_orders(orders)
        # swaps reaching past the live prefix are no-ops, not candidates
        Js = torch.where(((ci + 1) < m) & torch.isfinite(outs[5]),
                         outs[5], torch.inf)
        i = torch.argmin(Js)
        better = Js[i] < bestJ - 1e-12 * torch.clamp_min(bestJ.abs(), 1.0)
        if not read(better):
            break
        order, bestJ = orders[i], Js[i]
        out = tuple(o[i] for o in outs)
    return order, out


def stream_replan_core(sp, ladder, rem, w, active, B_live, B_key, warm,
                       certificate_rtol, *, fast, coarse=32,
                       descent_iters=40, cap_iters=64, stol_rel=None,
                       search_steps=64, read=torch.Tensor.tolist):
    """One replanning event on the device of ``rem`` (shared speedups).

    The decision cascade, every stage a real branch taken on the host so
    the common path pays one solve:

      1. **fresh solve** — rank the live set by normalized remaining
         size (SJF key under the *nominal* budget ``B_key``, weights
         break ties) and solve under the live budget, seeded with the
         carried ``WarmStart`` λ/bracket payload (validated on use, so
         a stale payload costs cold pricing, never a wrong answer);
      2. **exchange search** — if the J == J_linear certificate rejects
         the ranking (and m > 1), ``_exchange_search_shared``;
      3. **ladder** — still uncertified ⇒ the certificate-gated
         ``ladder_plan_table`` on the SJF ranking (solver failures are
         absorbed, never executed).

    ``rem``, ``w``, ``active`` are (M,) tensors; ``warm`` a WarmStart of
    (M,) λ hints and a (2,) bracket on the same device.  ``read`` turns
    a device flag into host values (one read after the fresh solve, one
    a search step, one after the search); pass a ``HostReads`` to count
    them.  Returns ``(order, table, m, certified, searched, J, J_linear,
    warm2)`` with ``order`` a full (M,) slot permutation (live prefix
    first), ``table`` the (M, M) plan to execute, ``m`` a device scalar,
    ``certified``/``searched`` host bools and ``warm2`` the carry for
    the next event.  ``StreamCascadePolicy`` (host loop) and
    ``serve.stream.StreamController.run_device`` call this *same*
    function, which makes the host loop a bit-comparable oracle for the
    device loop.
    """
    dtype, dev = rem.dtype, rem.device
    M = rem.shape[0]
    idx = torch.arange(M, device=dev)
    w = as_tensor(w, dev, dtype)
    act = as_tensor(active, dev, torch.bool) & (rem > 0)
    m = act.sum()
    B_live = as_tensor(B_live, dev, dtype)
    rate = sp.s(torch.full((), float(B_key), dtype=dtype, device=dev))
    key = torch.where(act, -(rem / torch.clamp_min(rate, _TINY)), torch.inf)
    order0 = _lexsort(torch.where(act, w, 0.0), key)

    def run_orders(orders):
        # one batched solve of P orders; each row carries the warm payload
        P = orders.shape[0]
        live = idx < m
        xs = torch.where(live, rem[orders], 0.0)
        ws = torch.where(live, w[orders], 0.0)
        return _solve(sp, xs, ws, B_live.expand(P).contiguous(),
                      m.expand(P).contiguous(), coarse, descent_iters,
                      cap_iters, fast,
                      lam0=warm.lam.expand(P, M).contiguous(),
                      stol_rel=stol_rel,
                      bracket0=warm.bracket.expand(P, 2).contiguous())

    out0 = tuple(o[0] for o in run_orders(order0[None]))
    cert0 = _stream_certified(out0[5], out0[6], certificate_rtol, dtype)
    certified, several = read(torch.stack([cert0, m > 1]))
    searched = (not certified) and several
    order1, out1 = order0, out0
    if searched:
        order1, out1 = _exchange_search_shared(run_orders, order0, out0, m,
                                               search_steps, read)
        certified = read(_stream_certified(out1[5], out1[6],
                                           certificate_rtol, dtype))
    if certified:
        order_f, table_f = order1, out1[0]
    else:
        from ..robust.degrade import ladder_plan_table
        order_f = torch.argsort(torch.where(act, -rem, torch.inf),
                                stable=True)
        rem_l = torch.where(idx < m, rem[order_f], 0.0)
        w_l = torch.where(idx < m, w[order_f], 0.0)
        table_f = ladder_plan_table(ladder, rem_l, w_l, B=B_live)
    warm2 = WarmStart(lam=out1[7], bracket=out1[8])
    return order_f, table_f, m, certified, searched, out1[5], out1[6], warm2


def stream_warm0(M: int, dtype=torch.float64, device=None) -> WarmStart:
    """The "no hint yet" WarmStart the cascade starts from: zero λ
    hints and the full-range cold bracket [tiny/eps, max/4] — ``_solve``
    treats both exactly like absent hints, so the first replan prices
    cold."""
    dev = resolve_device(device)
    fi = torch.finfo(dtype)
    return WarmStart(
        lam=torch.zeros((M,), dtype=dtype, device=dev),
        bracket=torch.tensor([fi.tiny / fi.eps, fi.max / 4.0], dtype=dtype,
                             device=dev))


class StreamCascadePolicy:
    """Host-side mirror of the device replanning cascade.

    Same ``plan``/``release``/``reset`` surface as
    ``StreamingSmartFillPolicy`` so it drops into ``StreamController``
    unchanged, but every decision — ranking, certificate, exchange
    search, warm-payload update — is made by the *same*
    ``stream_replan_core`` the device event loop calls.  Running the
    host event loop with this policy is therefore the differential
    oracle for ``StreamController.run_device``: the two share only the
    per-event planner and the window executor; event ordering, buffer
    promotion, queueing, backfill and metrics are independent code paths
    that must agree bit for bit.

    Counter semantics (device-mirrored, coarser than the streaming
    policy's): ``warm_replans`` counts replans certified on the fresh
    hinted solve, ``cold_replans`` counts escalations (search or
    ladder), ``order_searches`` counts search entries.  Solves run on
    ``device`` (default: the device of ``sp``'s leaves, else CUDA).
    """

    device_ready = False
    name = "cascadeSF"

    def __init__(self, sp: Speedup, B: float | None = None, *,
                 certificate_rtol: float = 1e-8, coarse: int = 32,
                 descent_iters: int = 40, cap_iters: int = 64,
                 stol_rel: float | None = None,
                 search_steps: int | None = None, ladder=None, device=None):
        self.device = resolve_device(device, sp)
        self.sp = collapse_homogeneous(_on(sp, self.device, torch.float64))
        if is_per_job(self.sp):
            raise ValueError(
                "StreamCascadePolicy is the shared-speedup cascade; "
                "per-job streams replan through "
                "StreamingSmartFillPolicy")
        self.B = float(sp.B if B is None else B)
        self.certificate_rtol = float(certificate_rtol)
        self.coarse = int(coarse)
        self.descent_iters = int(descent_iters)
        self.cap_iters = int(cap_iters)
        self.stol_rel = stol_rel
        self.search_steps = search_steps
        self._fast = _fast_ok(self.sp)
        if ladder is None:
            from ..robust.degrade import DegradingPolicy
            ladder = DegradingPolicy.ladder(self.sp, B=self.B)
        self.ladder = ladder
        self.reset()

    def reset(self) -> None:
        self.warm: WarmStart | None = None
        self.warm_replans = 0
        self.cold_replans = 0
        self.order_searches = 0

    def release(self, slots) -> None:
        """No carried order — nothing to forget on slot recycling."""

    def plan(self, rem, w, active=None, B=None) -> StreamPlan:
        dev = self.device
        rem = _host(rem)
        w = _host(w)
        M = rem.shape[0]
        act = (np.ones(M, bool) if active is None
               else np.asarray(active, bool))
        Bv = float(self.B if B is None else B)
        if self.warm is None or tuple(self.warm.lam.shape) != (M,):
            self.warm = stream_warm0(M, torch.float64, dev)
        steps = (4 * M if self.search_steps is None
                 else int(self.search_steps))
        order, table, m_, cert, sd, J, J_lin, warm2 = stream_replan_core(
            self.sp, self.ladder, as_tensor(rem, dev), as_tensor(w, dev),
            as_tensor(act, dev), Bv, self.B, self.warm,
            self.certificate_rtol, fast=self._fast, coarse=self.coarse,
            descent_iters=self.descent_iters, cap_iters=self.cap_iters,
            stol_rel=self.stol_rel, search_steps=steps)
        self.warm = warm2
        m = int(m_)
        self.warm_replans += int(cert and not sd)
        self.cold_replans += int(sd or not cert)
        self.order_searches += int(sd)
        return StreamPlan(order=order.cpu().numpy().astype(np.int64)[:m],
                          table=table, J=float(J), J_linear=float(J_lin),
                          m=m, B=Bv, warm=cert and not sd, certified=cert)

    def __call__(self, rem, w, active, B=None):
        """Host-policy adapter: the current-phase allocation column."""
        return as_tensor(self.plan(rem, w, active, B=B).slot_allocations(),
                         self.device)
