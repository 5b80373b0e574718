"""Class-aggregated planning: millions of jobs as dozens of classes.

A class is a job count n_c, a per-job remaining size x_c, a per-job
weight w_c and a Table-1 speedup family s_c.  Splitting a class's
bandwidth Θ equally over its n_c identical jobs (the symmetric optimum:
the jobs are exchangeable and s_c is concave) serves aggregate work at

    S_c(Θ) = n_c · s_c(Θ / n_c),

and for the regular family s_c'(θ) = A (w + σθ)^γ

    S_c'(Θ) = A (w + σΘ/n_c)^γ = A n_c^{−γ} (n_c w + σΘ)^γ,

the same family with A → A·n_c^{−γ} and w → n_c·w (γ and σ unchanged;
both sides vanish at Θ = 0, so the antiderivatives agree too, the
γ = −1 log branch included).  So C classes are a C-row §7 instance over
the aggregates

    X_c = n_c x_c,   W_c = n_c w_c,   sp_agg = class_speedup(sp, n),

and ``plan_classes`` is ``smartfill_hetero`` on it, at C rows.  At
n_c = 1 the transform is the identity bit for bit, so a class plan at
one job per class is the per-job plan.  All jobs of a class finish
together at T_c, and J = Σ_c n_c w_c T_c = Σ_c W_c T_c is the aggregate
plan's own J.

``plan_classes_reference`` is the host oracle: a pure-numpy SmartFill
recursion over the aggregates (λ-bisection CAP, grid and golden-section
μ*), sharing no code with the planner.

Zero-count classes are inert: they are stripped before the solve and
come back as T = 0, θ = 0 rows, so callers keep a fixed C-slot layout
while classes drain.

The planners run where ``device`` says, else on the device of the
speedup's leaves, in float64; the state's arrays stay on the host.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import as_tensor, resolve_device, vpow
from .smartfill import (HeteroSmartFillSchedule, _host, _on,
                        _permute_speedup, smartfill_hetero)
from .speedup import (RegularSpeedup, Speedup, StackedSpeedup, is_per_job,
                      map_leaves)

__all__ = [
    "ClassState",
    "ClassPlan",
    "class_speedup",
    "aggregate_classes",
    "compact_aggregate_batch",
    "plan_classes",
    "plan_classes_batched",
    "expand_classes",
    "plan_classes_reference",
]


# ---------------------------------------------------------------------------
# State
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClassState:
    """C job classes: counts, a size summary, per-job weights, families.

    counts[c] is the number of jobs in class c (0: the class is inert;
    fractional counts are allowed, the fluid executor drains counts
    continuously).  sizes[c] is the class's per-job remaining work (the
    jobs of a class are exchangeable, so only n_c·x_c enters the plan).
    ``sp`` holds one family per class, (C,)-leaved ``RegularSpeedup`` or
    ``StackedSpeedup``, or a shared scalar-leaf family.  The arrays are
    float64 numpy on the host.
    """

    counts: np.ndarray       # (C,) jobs per class, ≥ 0
    sizes: np.ndarray        # (C,) per-job remaining size x_c > 0
    weights: np.ndarray      # (C,) per-job weight w_c ≥ 0
    sp: Speedup              # per-class (C,) leaves or shared
    B: float

    def __post_init__(self):
        counts, sizes, weights = (_host(v) for v in
                                  (self.counts, self.sizes, self.weights))
        if not (counts.shape == sizes.shape == weights.shape):
            raise ValueError("counts, sizes and weights must all be (C,)")
        if counts.ndim != 1:
            raise ValueError("ClassState is single-instance: arrays are (C,)")
        if np.any(counts < 0):
            raise ValueError("class counts must be ≥ 0")
        if np.any(sizes[counts > 0] <= 0):
            raise ValueError("live classes need positive sizes")
        object.__setattr__(self, "counts", counts)
        object.__setattr__(self, "sizes", sizes)
        object.__setattr__(self, "weights", weights)
        object.__setattr__(self, "B", float(self.B))

    @property
    def C(self) -> int:
        return int(self.counts.shape[0])

    @property
    def jobs(self) -> float:
        """Total job count M = Σ n_c (a float: fluid counts drain)."""
        return float(np.sum(self.counts))


@dataclasses.dataclass(frozen=True)
class ClassPlan:
    """Class-aggregated SmartFill plan, scattered back to C slots.

    T[c] is class c's completion time (0 for empty classes); theta[c]
    the class's aggregate bandwidth in the earliest phase (t = 0, all
    active) and theta_job[c] the per-job share theta[c] / n_c.
    ``order[r]`` is the class in schedule row r (live classes only; row
    0 completes last).  J = Σ_c n_c w_c T_c; J_linear = Σ a_c X_c, equal
    to J iff the order is realized.  ``sched`` is the live-class
    ``HeteroSmartFillSchedule`` (None for the host oracle).
    """

    counts: np.ndarray
    T: np.ndarray
    theta: np.ndarray
    theta_job: np.ndarray
    order: np.ndarray
    J: float
    J_linear: float
    sched: HeteroSmartFillSchedule | None = None


def _empty_plan(counts) -> ClassPlan:
    C = counts.shape[0]
    return ClassPlan(counts=counts, T=np.zeros(C), theta=np.zeros(C),
                     theta_job=np.zeros(C), order=np.zeros(0, dtype=int),
                     J=0.0, J_linear=0.0, sched=None)


def _scatter_plan(counts, live, rows, T_rows, theta0_rows, J, J_lin,
                  sched=None) -> ClassPlan:
    """A plan over the live classes in schedule-row order, back in the
    C slots (``rows[r]`` indexes ``live``)."""
    C = counts.shape[0]
    order_cls = live[rows]
    T = np.zeros(C)
    theta0 = np.zeros(C)
    T[order_cls] = T_rows
    theta0[order_cls] = theta0_rows
    n_safe = np.where(counts > 0, counts, 1.0)
    return ClassPlan(counts=counts, T=T, theta=theta0,
                     theta_job=theta0 / n_safe, order=order_cls,
                     J=float(J), J_linear=float(J_lin), sched=sched)


# ---------------------------------------------------------------------------
# The aggregation transform
# ---------------------------------------------------------------------------

def class_speedup(sp: Speedup, counts) -> Speedup:
    """Aggregate speedup S_c(Θ) = n_c·s_c(Θ/n_c), exactly in-family.

    A → A·n^{−γ}, w → n·w; γ and σ unchanged.  A count of 0 is replaced
    by n = 1 (the identity), so inert classes keep valid parameters, and
    n = 1 leaves a class untouched bit for bit.  Broadcasts against
    ``counts``' shape ((K, C) counts give (K, C) leaves), in float64 on
    the device of ``sp``'s leaves.  A ``GenericSpeedup`` has no
    parameters to transform and raises ``TypeError``.
    """
    if not isinstance(sp, (RegularSpeedup, StackedSpeedup)):
        raise TypeError(
            f"class aggregation needs a regular-family speedup "
            f"(RegularSpeedup/StackedSpeedup), got {type(sp).__name__}: the "
            f"n·s(Θ/n) aggregate of a GenericSpeedup has no parameters to "
            f"transform")
    counts = as_tensor(counts, sp.device, torch.float64)
    n = torch.where(counts > 0, counts, 1.0)
    gamma = torch.broadcast_to(sp.gamma.to(n.dtype), n.shape)
    A = sp.A.to(n.dtype) * vpow(n, -gamma)
    w = sp.w.to(n.dtype) * n
    if isinstance(sp, RegularSpeedup):
        return RegularSpeedup(A=A, w=w, gamma=gamma, sigma=sp.sigma, B=sp.B)
    return StackedSpeedup(
        A=A, w=w, gamma=gamma,
        sigma=torch.broadcast_to(sp.sigma.to(n.dtype), n.shape), B=sp.B)


def aggregate_classes(state: ClassState):
    """(sp_agg, X, W): the §7 instance over the aggregates.

    X_c = n_c·x_c and W_c = n_c·w_c are exact zeros for empty classes,
    the padding convention of the batched planners.  X and W are float64
    tensors on the device of the state's speedup.
    """
    sp_agg = class_speedup(state.sp, state.counts)
    X = as_tensor(state.counts * state.sizes, sp_agg.device)
    W = as_tensor(state.counts * state.weights, sp_agg.device)
    return sp_agg, X, W


def expand_classes(state: ClassState):
    """The per-job instance: (x, w, sp_jobs, class_id).

    M = Σ n_c rows, class c contributing n_c identical jobs under its
    own family.  Counts must be integral (the fluid path has no per-job
    form).
    """
    counts = state.counts
    if np.any(np.abs(counts - np.round(counts)) > 1e-9):
        raise ValueError("expand_classes needs integral counts")
    reps = np.round(counts).astype(int)
    class_id = np.repeat(np.arange(state.C), reps)
    x = np.repeat(state.sizes, reps)
    w = np.repeat(state.weights, reps)
    if is_per_job(state.sp):
        sp_jobs = map_leaves(state.sp, lambda l: torch.repeat_interleave(
            l, torch.as_tensor(reps, device=l.device), dim=0)
            if l.ndim >= 1 else l)
    else:
        sp_jobs = state.sp
    return x, w, sp_jobs, class_id


# ---------------------------------------------------------------------------
# Planners
# ---------------------------------------------------------------------------

def plan_classes(
    state: ClassState,
    B: float | None = None,
    *,
    coarse: int = 64,
    descent_iters: int = 96,
    cap_iters: int = 64,
    exchange_passes: int = 2,
    exchange_window: int = 1,
    stol_rel: float | None = 1e-10,
    device=None,
) -> ClassPlan:
    """SmartFill over class aggregates: M = Σ n_c jobs as C rows.

    Strips empty classes, aggregates the rest (``class_speedup`` and the
    X/W products) and plans them with ``smartfill_hetero`` (sorted
    per-job CAP, μ* descent, exchange order search).  The μ* knobs
    default tighter than the per-job planner's: C ≲ 64 rows make the
    extra work cheap, and the 1e-8 contract against
    ``plan_classes_reference`` is linear in μ* wherever durations clamp.
    Results scatter back to the C slots; empty classes come back inert.
    An all-empty state is a no-op.
    """
    counts = state.counts
    B = float(state.B if B is None else B)
    live = np.flatnonzero(counts > 0)
    if live.size == 0:
        return _empty_plan(counts)
    dev = resolve_device(device, state.sp)
    n_l = counts[live]
    sp_l = class_speedup(
        _permute_speedup(_on(state.sp, dev, torch.float64), live), n_l)
    sched = smartfill_hetero(
        sp_l, n_l * state.sizes[live], n_l * state.weights[live], B=B,
        coarse=coarse, descent_iters=descent_iters, cap_iters=cap_iters,
        exchange_passes=exchange_passes, exchange_window=exchange_window,
        stol_rel=stol_rel, device=dev)
    return _scatter_plan(counts, live, np.asarray(sched.order),
                         _host(sched.T), _host(sched.theta[:, -1]),
                         sched.J, sched.J_linear, sched)


def plan_classes_batched(counts, sizes, weights, sp, B=None, device=None,
                         **kwargs):
    """K class instances planned in one batched call.

    Per instance the live classes are compacted to a prefix (empty
    classes become exact-zero suffix rows), the aggregation transform is
    applied to the (K, C) leaves, and the batch goes through
    ``smartfill_hetero_batched``.  Returns ``(orders, sched)``:
    ``orders[k][r]`` is the class slot of instance k in schedule row r
    (empty classes in the trailing rows), ``sched`` the live-prefix
    ``BatchedSmartFillSchedule`` over the aggregates (its J is the
    per-job objective).  The μ* knobs default to ``plan_classes``'s
    (``coarse=64``, ``descent_iters=96``, ``stol_rel=1e-10``).
    """
    from .batch import smartfill_hetero_batched

    if B is None:
        B = sp.B
    kwargs.setdefault("coarse", 64)
    kwargs.setdefault("descent_iters", 96)
    kwargs.setdefault("stol_rel", 1e-10)
    dev = resolve_device(device, sp)
    perm, sp_agg, X, W = compact_aggregate_batch(
        counts, sizes, weights, _on(sp, dev, torch.float64))
    orders, sched = smartfill_hetero_batched(sp_agg, X, W, B=B, device=dev,
                                             **kwargs)
    # schedule row r → compacted slot orders[k, r] → class slot
    return np.take_along_axis(perm, orders, axis=1), sched


def compact_aggregate_batch(counts, sizes, weights, sp):
    """Host-side preparation of the batched class planner.

    Per instance a stable live-first compaction, then the aggregation
    transform on the (K, C) leaves.  Returns ``(perm, sp_agg, X, W)``:
    ``perm[k]`` the compaction of instance k (numpy), ``sp_agg`` on the
    device of ``sp``'s leaves, X/W numpy with zero padding.
    """
    counts, sizes, weights = (_host(v) for v in (counts, sizes, weights))
    if counts.ndim != 2:
        raise ValueError("class batches are (K, C) arrays")
    K, C = counts.shape
    # argsort of the "empty" flag keeps the order within both groups
    perm = np.argsort(counts <= 0, axis=1, kind="stable")
    n_p = np.take_along_axis(counts, perm, axis=1)
    x_p = np.take_along_axis(sizes, perm, axis=1)
    w_p = np.take_along_axis(weights, perm, axis=1)

    def permute_leaf(l):
        p = torch.as_tensor(perm, device=l.device)
        if l.ndim >= 2 and tuple(l.shape[:2]) == (K, C):
            return l.gather(1, p)
        if l.ndim == 1 and l.shape[0] == C:
            return l[p]               # shared per-class → per-instance
        return l

    sp_agg = class_speedup(map_leaves(sp, permute_leaf), n_p)
    live = n_p > 0
    X = np.where(live, n_p * x_p, 0.0)
    W = np.where(live, n_p * w_p, 0.0)
    return perm, sp_agg, X, W


# ---------------------------------------------------------------------------
# Host oracle: pure numpy
# ---------------------------------------------------------------------------

def _np_family(sp: Speedup, C: int):
    """(A, w, γ, σ) as (C,) float64 numpy arrays; rejects non-regular."""
    if isinstance(sp, RegularSpeedup):
        sigma = np.full(C, float(sp.sigma))
    elif isinstance(sp, StackedSpeedup):
        sigma = np.broadcast_to(_host(sp.sigma), (C,))
    else:
        raise TypeError(
            f"plan_classes_reference needs a regular-family speedup, got "
            f"{type(sp).__name__}")
    A = np.broadcast_to(_host(sp.A), (C,)).copy()
    w = np.broadcast_to(_host(sp.w), (C,)).copy()
    g = np.broadcast_to(_host(sp.gamma), (C,)).copy()
    return A, w, g, np.asarray(sigma, np.float64).copy()


def _np_ds(A, w, g, sg, th):
    return A * (w + sg * th) ** g


def _np_s(A, w, g, sg, th):
    base = w + sg * th
    g1 = g + 1.0
    is_log = np.abs(g1) < 1e-12
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        w_safe = np.where(w > 0, w, 1.0)
        log_b = (A / sg) * (np.log(np.maximum(base, 1e-300))
                            - np.log(w_safe))
        g1s = np.where(is_log, 1.0, g1)
        pow_b = (A / (sg * g1s)) * (base ** g1s - w ** g1s)
    return np.where(is_log, log_b, pow_b)


def _np_ds_inv(A, w, g, sg, y):
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        out = sg * ((y / A) ** (1.0 / g) - w)
    # an overflowed (y/A)^{1/γ} means "θ beyond any budget", not
    # "parked": keep the sign so the caller's [0, b] clip picks the edge
    return np.nan_to_num(out, nan=0.0, posinf=1e300, neginf=-1e300)


def _np_cap(A, w, g, sg, c, b, iters: int = 160):
    """CAP by λ-bisection: θ_i = (ds_inv_i(λ c_i))₊ with Σ θ = b.

    The total allocation is strictly decreasing in λ, so a log-space
    bisection over e^±690 (all of float64) converges in ~160 halvings;
    the result is rescaled onto b over its support.
    """
    lo, hi = -690.0, 690.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        th = np.clip(_np_ds_inv(A, w, g, sg, np.exp(mid) * c), 0.0, b)
        if th.sum() > b:
            lo = mid
        else:
            hi = mid
    th = np.clip(_np_ds_inv(A, w, g, sg, np.exp(0.5 * (lo + hi)) * c),
                 0.0, b)
    total = th.sum()
    if total > 0:
        th = th * (b / total)
    return th


def _np_minimize(F, B, coarse: int = 64, golden_iters: int = 120):
    """Grid-localized golden-section argmin of F on (0, B]."""
    invphi, invphi2 = 0.6180339887498949, 0.3819660112501051
    fi = np.finfo(np.float64)
    lo_edge = max(B * 1e-9, fi.tiny / fi.eps)
    g1 = np.geomspace(lo_edge, B, coarse // 2 + 1)[:-1]
    g2 = np.linspace(B / (coarse // 2), B, coarse // 2)
    mus = np.sort(np.concatenate([g1, g2]))
    vals = np.array([F(mu) for mu in mus])
    finite = np.isfinite(vals)
    if not finite.any():
        return B, np.inf
    i = int(np.argmin(np.where(finite, vals, np.inf)))
    best_mu, best_val = mus[i], vals[i]
    lo, hi = mus[max(i - 1, 0)], mus[min(i + 1, len(mus) - 1)]
    x1 = lo + invphi2 * (hi - lo)
    x2 = lo + invphi * (hi - lo)
    f1, f2 = F(x1), F(x2)

    def fin(v):                                       # NaN → +inf
        return v if np.isfinite(v) else np.inf

    for _ in range(golden_iters):
        if fin(f1) <= fin(f2):
            hi, x2, f2 = x2, x1, f1
            x1 = lo + invphi2 * (hi - lo)
            f1 = F(x1)
        else:
            lo, x1, f1 = x1, x2, f2
            x2 = lo + invphi * (hi - lo)
            f2 = F(x2)
    for mu, val in ((x1, f1), (x2, f2)):
        if np.isfinite(val) and val < best_val:
            best_mu, best_val = mu, val
    return float(best_mu), float(best_val)


def plan_classes_reference(
    state: ClassState,
    B: float | None = None,
    order=None,
    *,
    coarse: int = 64,
    golden_iters: int = 120,
) -> ClassPlan:
    """Host-loop class water-filler: the differential oracle.

    A pure-numpy SmartFill recursion over the class aggregates (a Python
    loop over k, λ-bisection CAP, grid and golden-section μ*) that
    shares no code with the planner.  Solves the completion ``order``
    given (class indices in schedule-row order, live classes only;
    default SJF by normalized aggregate size, the planner's starting
    heuristic; pass a plan's ``.order`` to pin its searched order).
    Empty classes are inert as in ``plan_classes``.
    """
    counts = state.counts
    C = counts.shape[0]
    B = float(state.B if B is None else B)
    live = np.flatnonzero(counts > 0)
    if live.size == 0:
        return _empty_plan(counts)
    n_l = counts[live]
    A, wsh, g, sg = (v[live] for v in _np_family(state.sp, C))
    A = A * n_l ** (-g)                 # the aggregation transform
    wsh = wsh * n_l
    X = n_l * state.sizes[live]
    W = n_l * state.weights[live]
    if order is None:
        with np.errstate(divide="ignore"):
            t_solo = X / np.maximum(
                _np_s(A, wsh, g, sg, np.full(live.size, B)), 1e-300)
        rows = np.lexsort((W, -t_solo))     # positions into `live`
    else:
        pos = {int(cl): i for i, cl in enumerate(live)}
        rows = np.array([pos[int(cl)] for cl in np.asarray(order, int)],
                        dtype=int)
    k_live = rows.size
    A, wsh, g, sg = A[rows], wsh[rows], g[rows], sg[rows]
    Xo, Wo = X[rows], W[rows]

    # SmartFill recursion k = 0..k_live−1 (eqs. (28)/(29))
    c = np.zeros(k_live)
    a = np.zeros(k_live)
    theta = np.zeros((k_live, k_live))
    c[0] = 1.0
    a[0] = Wo[0] / _np_s(A[:1], wsh[:1], g[:1], sg[:1], np.array([B]))[0]
    theta[0, 0] = B
    for k in range(1, k_live):
        Ak, wk, gk, sk = A[:k], wsh[:k], g[:k], sg[:k]
        Wk = Wo[: k + 1].sum()

        def F(mu):
            th = _np_cap(Ak, wk, gk, sk, c[:k], B - mu)
            served = (a[:k] * _np_s(Ak, wk, gk, sk, th)).sum()
            s_new = _np_s(A[k : k + 1], wsh[k : k + 1], g[k : k + 1],
                          sg[k : k + 1], np.array([mu]))[0]
            return (Wk - served) / s_new

        mu, a_next = _np_minimize(F, B, coarse=coarse,
                                  golden_iters=golden_iters)
        th = _np_cap(Ak, wk, gk, sk, c[:k], B - mu)
        theta[:k, k] = th
        theta[k, k] = mu
        a[k] = a_next
        ds_prev = _np_ds(A[k - 1 : k], wsh[k - 1 : k], g[k - 1 : k],
                         sg[k - 1 : k], np.array([th[k - 1]]))[0]
        ds_new = _np_ds(A[k : k + 1], wsh[k : k + 1], g[k : k + 1],
                        sg[k : k + 1], np.array([mu]))[0]
        c[k] = max(c[k - 1] * ds_new / ds_prev, 1e-300)

    # back-substitute durations: X = R d, R[j, m] = S_j(Θ[j, m]), m ≥ j
    rate = _np_s(A[:, None], wsh[:, None], g[:, None], sg[:, None], theta)
    d = np.zeros(k_live)
    for j in range(k_live - 1, -1, -1):
        acc = Xo[j] - rate[j, j + 1 :] @ d[j + 1 :]
        d[j] = max(acc / rate[j, j], 0.0)
    T_rows = np.cumsum(d[::-1])[::-1]
    return _scatter_plan(counts, live, rows, T_rows, theta[:, -1],
                         Wo @ T_rows, a @ Xo)
