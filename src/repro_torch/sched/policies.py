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
from ..core.smartfill import _host, _is_pure_power, _solve
from ..core.speedup import (RegularSpeedup, Speedup, StackedSpeedup,
                            inner_per_job, map_leaves, per_instance)

__all__ = [
    "Policy",
    "SmartFillPolicy",
    "HeteroSmartFillPolicy",
    "ClassSmartFillPolicy",
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
