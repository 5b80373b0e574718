"""SmartFill — Algorithm 2 of the paper: the complete solution to OPT.

OPT: minimize J = Σ w_i T_i over allocations θ_i(t), Σθ ≤ B, for M jobs
with sizes x_1 ≥ … ≥ x_M, weights w_1 ≤ … ≤ w_M, and a common concave
speedup s(θ).  Allocations are piecewise constant between completions and
jobs complete in SJF order, so the policy is an upper-triangular Θ where
Θ[i, j] is the rate of job i+1 during phase j+1 (jobs 1..j+1 active;
column M−1 is the first interval in time).

SmartFill builds Θ column by column from the last-completed job outward,
carrying the CDR constants c_k (Cor. 2.1) and the value-function
coefficients a_k of Prop. 9 (J* = Σ a_i x_i):

  iteration 1:   θ¹₁ = B, c₁ = 1, a₁ = w₁ / s(B)
  iteration k+1: μ* = argmin_μ F(μ),
                 F(μ) = (Σ_{i≤k+1} w_i − Σ_{i≤k} a_i s(CAP_i(B−μ, c))) / s(μ)
                 θ^{k+1}_{k+1} = μ*;  θ^{k+1}_i = CAP_i(B−μ, c)
                 c_{k+1} = c_k · s'(μ*) / s'(θ^{k+1}_k)
                 a_{k+1} = F(μ*)

(The paper prints arg max in (26); a_{k+1} is a marginal cost, so the
operation is arg min.)

The recursion here is written batch-first: ``_solve`` takes (N, M)
sizes and weights with an (N,) count of live jobs per instance, runs the
iterations k = 1..M−1 as a Python loop whose every step is a batch of
tensor operations (nothing syncs to the host), and the single-instance
``smartfill`` is N = 1.  Per iteration the μ* minimizer is a mixed
log+linear localization grid followed by golden-section descent; for the
pure-power family (the heSRPT case) μ* is closed form.  The CAP inside F
is the prefix-sum closed form for a shared RegularSpeedup and a
warm-started λ-bisection otherwise — never the float32 CUDA kernels:
the recursion runs in the caller's dtype (float64 for reference
precision; in float32 the minimizer loses ~1e-3 relative J on
near-linear speedups, p ≳ 0.9, while the closed-form μ* path stays exact).

Per-job speedups (paper §7): every job may carry its own concave s_i
through job-indexed leaves ((M,) for one instance, (N, M) for a batch).
The CAP then runs the sorted-breakpoint solver (``hetero_prepare`` /
``hetero_solve``) over a breakpoint store that grows by one job an
iteration, and μ* comes from ``_minimize_f_hinted``: a localization grid
priced exactly (λ* threaded through it, M < 33) or with the one-pass
``hetero_approx``, an exact re-pricing of the cells around its argmin,
and a safeguarded parabolic descent whose probes carry λ* forward.
Every diagonal term (F's denominator, the CDR update, a₁) uses job k's
own s_k.  ``smartfill_hetero`` also searches the completion order (SJF
by normalized size, then steepest exchange descent, its candidates one
batch of ``_solve``); ``smartfill_warm`` carries λ* and the λ-bracket
across calls (``WarmStart``); ``smartfill_reference`` and
``smartfill_hetero_reference`` are the host-loop oracles.

Loops that the JAX package ends with a ``while_loop`` (the descent's
vertex exit, the CAP's Newton and bisection exits) run a fixed count
here with every row frozen, bit for bit, from its own exit on: on the
CPU they stop once all rows are frozen, on the card they run out their
count, and both give the same result.
"""
from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from .._device import as_tensor, resolve_device, stops_early, vpow
from .gwf import (HeteroPrep, _hetero_prepare, hetero_approx,
                  hetero_breakpoints_init, hetero_breakpoints_insert,
                  hetero_solve, solve_cap, solve_cap_generic,
                  waterfill_prepare, waterfill_solve, waterfill_solve_many)
from .speedup import (RegularSpeedup, Speedup, StackedSpeedup,
                      collapse_homogeneous, host_call, inner_per_job,
                      is_per_job, leaves, map_leaves, per_instance, rowwise,
                      take_job)

__all__ = [
    "SmartFillSchedule",
    "HeteroSmartFillSchedule",
    "WarmStart",
    "smartfill",
    "smartfill_warm",
    "smartfill_hetero",
    "smartfill_reference",
    "smartfill_hetero_reference",
    "smartfill_allocations",
    "completion_times",
    "normalized_order",
    "objective",
]


@dataclasses.dataclass(frozen=True)
class SmartFillSchedule:
    """Output of SmartFill.

    theta[i, j]: rate of job i during phase j (phase j has jobs 0..j
      active; phase M−1 is earliest in time).  Upper-triangular.
    c: (M,) CDR constants (Cor. 2.1), c[0] = 1, non-increasing.
    a: (M,) value-function coefficients (Prop. 9), non-decreasing.
    durations: (M,) phase lengths.
    T: (M,) completion times, T[0] > T[1] > … > T[M−1] (SJF order).
    J: optimal objective Σ w_i T_i.
    J_linear: Σ a_i x_i — must equal J (Prop. 9); kept for validation.
    """

    theta: torch.Tensor
    c: torch.Tensor
    a: torch.Tensor
    durations: torch.Tensor
    T: torch.Tensor
    J: float
    J_linear: float


def _is_pure_power(sp: Speedup) -> bool:
    """True iff every instance of ``sp`` is s = aθ^p (closed-form μ*)."""
    if not isinstance(sp, RegularSpeedup) or sp.sigma != +1:
        return False
    return bool(torch.all(sp.w == 0.0)
                and torch.all((-1.0 < sp.gamma) & (sp.gamma < 0.0)))


def _fast_ok(sp: Speedup, n_instances: int | None = None) -> bool:
    """True iff the closed-form μ* path is valid for ``sp`` as solved:
    pure power with one exponent per instance (no job-indexed leaves)."""
    return _is_pure_power(sp) and not inner_per_job(sp, n_instances)


# Golden-section constants: φ⁻¹ and φ⁻² (= 1 − φ⁻¹).
_INVPHI = 0.6180339887498949
_INVPHI2 = 0.3819660112501051
# Warm λ-bracket widening between SmartFill iterations (generic path); a
# larger move of λ* is caught by the bracket validation of the solve.
_WARM_WIDEN = 256.0
# Adaptive λ-bisection exit: stop once hi ≤ lo·(1 + rel_tol).
_CAP_REL_TOL = 1e-13


def _mu_floor(B, dtype):
    """Positive lower edge of the μ-minimizer's domain: B·1e-9, floored
    at tiny/eps of the dtype so it never underflows to 0 (μ = 0 puts
    s(0) = 0 on the phase-rate diagonal)."""
    fi = torch.finfo(dtype)
    return torch.clamp_min(B * 1e-9, fi.tiny / fi.eps)


def _linspace(start, stop, num):
    """Per-row linspace (N,) → (N, num), JAX's formula and endpoint."""
    div = num - 1
    step = torch.arange(div, dtype=start.dtype, device=start.device) / div
    out = start[:, None] * (1 - step) + stop[:, None] * step
    return torch.cat([out, stop[:, None]], -1)


def _geomspace(start, stop, num):
    """Per-row geomspace for positive bounds, as 10^linspace(log10)."""
    return vpow(10.0, _linspace(torch.log10(start), torch.log10(stop), num))


# Below this many jobs the per-job μ-localization grid is priced with
# exact (λ-threaded) CAP solves instead of the one-pass approximation:
# few jobs means few breakpoints, and across a wide segment the
# log-secant's bias can misplace the grid argmin by several cells.
_APPROX_GRID_MIN_M = 33


class _Lanes:
    """Views of one speedup for a batch of N instances × M jobs.

    ``jobs`` broadcasts against (N, M), ``grid`` against (N, P, M) (P
    budgets per instance), ``rows`` against Θ's (N, M, M) with row i
    job i's function, and ``job(k, nd)`` is job k's own function
    broadcasting against (N,) + (1,)·nd.  A shared speedup (scalar or
    per-instance (N,) leaves) gives the same function to every job; a
    per-job one has every non-scalar leaf expanded to (N, M).
    """

    def __init__(self, sp, N: int, M: int):
        self.per_job = inner_per_job(sp, N)
        self.sp = sp
        self.N = N
        if not self.per_job:
            self.jobs = per_instance(sp, N, 1)
            self.grid = self.rows = per_instance(sp, N, 2)
            return

        def full(l):
            if l.ndim == 0:
                return l
            if l.ndim == 1 and l.shape[0] == N:
                l = l[:, None]                  # per instance
            return l.expand(N, M)

        self.jobs = map_leaves(sp, full)
        self.grid = map_leaves(self.jobs, lambda l: l[:, None, :]
                               if l.ndim else l)
        self.rows = map_leaves(self.jobs, lambda l: l[:, :, None]
                               if l.ndim else l)

    def job(self, k: int, nd: int = 0):
        if not self.per_job:
            return per_instance(self.sp, self.N, nd)
        return map_leaves(self.jobs, lambda l: l[:, k].reshape(
            (self.N,) + (1,) * nd) if l.ndim else l)


def _f_grid(sp, mus, c, a, k, W, B):
    """F(μ) over a grid for every instance: mus (N, G) → (N, G).

    c/a are (N, M) with the first k entries live.  The one-shot form of
    the priced grid, with a cold CAP solve per point (the host-loop
    oracle's); F's denominator is job k's own s_k(μ).
    """
    N, M = c.shape
    G = mus.shape[-1]
    ln = _Lanes(sp, N, M)
    active = (torch.arange(M, device=c.device) < k).expand(N, G, M)
    th = solve_cap(ln.grid, B[:, None] - mus,
                   c[:, None, :].expand(N, G, M), active)
    served = torch.where(active, a[:, None, :] * ln.grid.s(th),
                         0.0).sum(-1)
    return (W[:, None] - served) / ln.job(k, 1).s(mus)


def _argmin_bracket(mus, vals, n):
    """(best μ, best F, bracket lo, bracket hi, ok) per row of a grid.

    ``ok`` is False when every grid value is non-finite (a degenerate
    instance); the caller then keeps a finite fallback.
    """
    finite = torch.isfinite(vals)
    i = torch.argmin(torch.where(finite, vals, torch.inf), -1, keepdim=True)
    lo = mus.gather(-1, (i - 1).clamp_min(0))
    hi = mus.gather(-1, (i + 1).clamp_max(n - 1))
    return (mus.gather(-1, i)[:, 0], vals.gather(-1, i)[:, 0], lo[:, 0],
            hi[:, 0], finite.any(-1))


def _uses_closed_cap(ln: _Lanes) -> bool:
    """Can the CAP use the prefix-sum closed form?  Only a shared (per
    instance) RegularSpeedup has the common auxiliary curve it needs."""
    return isinstance(ln.sp, RegularSpeedup) and not ln.per_job


def _uses_sorted_cap(ln: _Lanes) -> bool:
    """Does the CAP take the sorted-breakpoint per-job solver?  Any
    per-job regular family (job-indexed RegularSpeedup leaves or a
    StackedSpeedup) has closed-form activation breakpoints; per-job
    leaves exist only on those two classes."""
    return ln.per_job and isinstance(ln.sp, (RegularSpeedup, StackedSpeedup))


def _make_f(ln, c, a, k, W, B, warm, cap_iters):
    """Build (F, cap) for one SmartFill iteration over N instances with a
    shared speedup.

    ``F(μ)`` prices (N, P) candidate μ at once and returns (N, P);
    ``cap(μ)`` solves the CAP at the chosen (N,) μ* and returns
    ``(θ, λ-bracket)``.  On the closed-form path the water-filling curve
    is factorized once here (its sort depends on c only), so every
    budget costs O(k).  Otherwise each F evaluation is a λ-bisection
    warm-started from the carried bracket (widened once here) with the
    adaptive exit, and cap runs the full-precision bisection and returns
    the bracket to carry forward.
    """
    N, M = c.shape
    active = (torch.arange(M, device=c.device) < k).expand(N, M)
    sp_k = ln.job(k, 1)

    def price(th, mu):
        # th (N, P, M), mu (N, P)
        served = torch.where(active[:, None, :],
                             a[:, None, :] * ln.grid.s(th), 0.0).sum(-1)
        return (W[:, None] - served) / sp_k.s(mu)

    if _uses_closed_cap(ln):
        u = torch.where(active, ln.jobs.bottle_width(c), 0.0)
        h0 = ln.jobs.bottle_bottom(c)
        prep = waterfill_prepare(u, h0, active)

        def F(mu):
            return price(waterfill_solve_many(prep, u, h0, B[:, None] - mu,
                                              active), mu)

        def cap(mu):
            return waterfill_solve(prep, u, h0, B - mu, active), warm
        return F, cap

    bracket = (warm[0] / _WARM_WIDEN, warm[1] * _WARM_WIDEN)

    def F(mu):
        P = mu.shape[-1]
        th = solve_cap_generic(
            ln.grid, B[:, None] - mu, c[:, None, :].expand(N, P, M),
            active[:, None, :].expand(N, P, M), iters=cap_iters,
            bracket=(bracket[0][:, None].expand(N, P),
                     bracket[1][:, None].expand(N, P)),
            rel_tol=_CAP_REL_TOL)
        return price(th, mu)

    def cap(mu):
        return solve_cap_generic(ln.jobs, B - mu, c, active, iters=96,
                                 bracket=bracket, return_bracket=True)
    return F, cap


def _sorted_probes(ln, c, a, k, W, B, bp, cap_iters, precise):
    """The probes of one per-job SmartFill iteration (sorted CAP).

    Returns ``(F_grid, F_chain, F_desc, cap)`` over N instances, all on
    one ``hetero_prepare`` of the breakpoint store ``bp``:
      * ``F_grid(mus (N, G), hint0 (N,))`` prices the localization grid
        — exactly, with λ* threaded left to right, when M < 33 and
        ``precise`` (grid μ ascending ⇒ budget descending ⇒ λ*
        ascending, so every solve is warm); with a cold six-step solve
        per point at M < 33 otherwise; with ``hetero_approx`` at
        M ≥ 33, where the breakpoints are dense enough for it;
      * ``F_chain(mu, hint)`` / ``F_desc(mu, hint)`` price one (N,) μ
        with a warm four- (descent: two, or four at M < 33 when
        ``precise``) step solve and return ``(F, λ*)``;
      * ``cap(mu, hint)`` is the final solve at μ*, ``(θ, λ*)``.
    """
    N, M = c.shape
    active = (torch.arange(M, device=c.device) < k).expand(N, M)
    prep = _hetero_prepare(ln.jobs, c, active, breakpoints=bp)
    sp_k, sp_k1 = ln.job(k), ln.job(k, 1)
    small = M < _APPROX_GRID_MIN_M

    def price(th, mu):
        # th (N, M), mu (N,)
        served = torch.where(active, a * ln.jobs.s(th), 0.0).sum(-1)
        return (W - served) / sp_k.s(mu)

    def price_grid(th, mus):
        # th (N, G, M), mus (N, G)
        served = torch.where(active[:, None, :],
                             a[:, None, :] * ln.grid.s(th), 0.0).sum(-1)
        return (W[:, None] - served) / sp_k1.s(mus)

    def solve(mu, hint, unroll):
        return hetero_solve(prep, B - mu, iters=cap_iters, lam_hint=hint,
                            return_lam=True, unroll=unroll)

    def F_chain(mu, hint):
        th, lam = solve(mu, hint, 4)
        return price(th, mu), lam

    desc_unroll = 4 if (small and precise) else 2

    def F_desc(mu, hint):
        th, lam = solve(mu, hint, desc_unroll)
        return price(th, mu), lam

    if small and precise:
        def F_grid(mus, hint0):
            vals, h = [], hint0
            for g in range(mus.shape[-1]):
                v, h = F_chain(mus[:, g], h)
                vals.append(v)
            return torch.stack(vals, -1)
    elif small:
        def F_grid(mus, hint0):
            G = mus.shape[-1]
            prep_g = HeteroPrep(*(f[:, None].expand(N, G, M) for f in prep))
            th = hetero_solve(prep_g, B[:, None] - mus, iters=cap_iters,
                              unroll=6)                     # (N, G, M)
            return price_grid(th, mus)
    else:
        def F_grid(mus, hint0):
            return price_grid(hetero_approx(prep, B[:, None] - mus), mus)

    def cap(mu, hint):
        return solve(mu, hint, 4)
    return F_grid, F_chain, F_desc, cap


def _minimize_f(F, B, coarse, descent_iters):
    """argmin_μ F(μ) on (0, B] per instance: localization + golden section.

    A mixed log+linear ``coarse``-point grid places the basin of the
    unimodal F (the log half resolves basins near μ→0); golden section
    then contracts the bracketing cell by φ⁻¹ per iteration with one F
    evaluation per instance.  If every probe is non-finite the
    minimizer returns the finite fallback μ = B.
    """
    lo = _mu_floor(B, B.dtype)
    half = coarse // 2
    # the log half excludes its B endpoint: two coincident top points
    # would collapse the golden bracket to [B−ulp, B]
    g1 = _geomspace(lo, B, half + 1)[:, :-1]
    g2 = _linspace(B / half, B, half)
    mus = torch.sort(torch.cat([g1, g2], -1), -1).values
    vals = F(mus)
    mu0, val0, mu_lo, mu_hi, ok = _argmin_bracket(mus, vals, mus.shape[-1])

    span = mu_hi - mu_lo
    x1 = mu_lo + _INVPHI2 * span
    x2 = mu_lo + _INVPHI * span
    f12 = F(torch.stack([x1, x2], -1))
    f1, f2 = f12[:, 0], f12[:, 1]
    glo, ghi = mu_lo, mu_hi
    for _ in range(descent_iters):
        left = (torch.where(torch.isnan(f1), torch.inf, f1)
                <= torch.where(torch.isnan(f2), torch.inf, f2))
        glo = torch.where(left, glo, x1)
        ghi = torch.where(left, x2, ghi)
        span = ghi - glo
        p = torch.where(left, glo + _INVPHI2 * span, glo + _INVPHI * span)
        fp = F(p[:, None])[:, 0]
        x1, x2, f1, f2 = (torch.where(left, p, x2), torch.where(left, x1, p),
                          torch.where(left, fp, f2), torch.where(left, f1, fp))

    # best of the two interior points and the coarse argmin itself
    cand_mu = torch.stack([mu0, x1, x2], -1)
    cand_f = torch.stack([val0, f1, f2], -1)
    i = torch.argmin(torch.where(torch.isfinite(cand_f), cand_f, torch.inf),
                     -1, keepdim=True)
    mu, val = cand_mu.gather(-1, i)[:, 0], cand_f.gather(-1, i)[:, 0]
    bad = ~(ok & torch.isfinite(val))
    return torch.where(bad, B, mu), torch.where(bad, torch.inf, val)


def _minimize_f_hinted(F_grid, F_chain, F_desc, B, coarse, descent_iters,
                       hint0, stol_rel=3e-7, window=5, live=None):
    """``_minimize_f`` for the sorted per-job CAP, per instance.

    The localization grid is priced by ``F_grid``; a ``window``-point
    neighbourhood of its argmin is re-priced exactly with λ* threaded
    through ``F_chain`` (the grid's approximation can flip near-minimum
    comparisons a cell either way), which picks the bracketing triple;
    then a safeguarded successive-parabolic descent, whose probes carry
    λ* forward through ``F_desc``, runs until the bracket is tighter
    than min(4e-9, ``stol_rel``)·span or the vertex stops moving by more
    than ``stol_rel``·span (at most ``descent_iters`` steps).  A
    non-contracting or concave parabola falls back to the golden step
    into the larger sub-interval.  Each row stops at its own exit and
    keeps its state from then on; rows where ``live`` is False (an
    iteration past their job count, a padded instance) count as stopped
    from the start: the caller discards their μ.  Returns ``(μ*, F(μ*),
    λ_last)`` per instance; the caller seeds the final CAP solve with
    ``λ_last``.
    """
    dtype = B.dtype
    lo = _mu_floor(B, dtype)
    half = coarse // 2
    g1 = _geomspace(lo, B, half + 1)[:, :-1]
    g2 = _linspace(B / half, B, half)
    mus = torch.sort(torch.cat([g1, g2], -1), -1).values
    vals = F_grid(mus, hint0)
    finite = torch.isfinite(vals)
    ok = finite.any(-1)
    G = mus.shape[-1]
    j0 = torch.argmin(torch.where(finite, vals, torch.inf), -1)

    ws = window if G >= window else G
    hw = ws // 2
    jc = torch.clamp(j0, hw, G - ws + hw)
    pts = mus.gather(-1, (jc - hw)[:, None]
                     + torch.arange(ws, device=mus.device))
    fl, lam = [], hint0
    for t in range(ws):
        ft, lam = F_chain(pts[:, t], lam)
        fl.append(ft)
    fs = torch.stack(fl, -1)
    fs = torch.where(torch.isfinite(fs), fs, torch.inf)
    # the window's argmin may sit on its edge (a boundary minimum at
    # μ = B): keep it as a final candidate, as ``_minimize_f`` keeps its
    # grid argmin
    kbest = torch.argmin(fs, -1, keepdim=True)
    mu_w, f_w = pts.gather(-1, kbest)[:, 0], fs.gather(-1, kbest)[:, 0]
    kk = torch.clamp(kbest, 1, ws - 2)

    def at(v, d):
        return v.gather(-1, kk + d)[:, 0]

    xa, xm, xb = at(pts, -1), at(pts, 0), at(pts, 1)
    fa, fm, fb = at(fs, -1), at(fs, 0), at(fs, 1)
    span0 = xb - xa
    tol = min(4e-9, stol_rel) * span0
    stol = stol_rel * span0
    done = torch.zeros_like(ok) if live is None else ~live
    for _ in range(descent_iters):
        run = (xb - xa > tol) & ~done
        if stops_early(~run):
            break
        # parabolic vertex through the triple
        d1 = (xm - xa) * (fm - fb)
        d2 = (xm - xb) * (fm - fa)
        den = 2.0 * (d1 - d2)
        u_p = xm - ((xm - xa) * d1 - (xm - xb) * d2) / torch.where(
            den != 0.0, den, 1.0)
        # den < 0 ⟺ the parabola is convex; a concave fit puts u_p at its
        # maximum
        ok_p = (den < 0.0) & torch.isfinite(u_p) & (u_p > xa) & (u_p < xb)
        # a vertex that stopped moving is convergence
        done2 = ok_p & (torch.abs(u_p - xm) < stol)
        left_big = (xm - xa) >= (xb - xm)
        g = torch.where(left_big, xm - _INVPHI2 * (xm - xa),
                        xm + _INVPHI2 * (xb - xm))
        u = torch.where(ok_p & (torch.abs(u_p - xm) >= stol), u_p, g)
        fu, lam2 = F_desc(u, lam)
        fu = torch.where(torch.isnan(fu), torch.inf, fu)
        # bracket update keeping an interior minimum
        ul = u < xm
        better = fu <= fm
        new = (torch.where(ul, torch.where(better, xa, u),
                           torch.where(better, xm, xa)),
               torch.where(better, u, xm),
               torch.where(ul, torch.where(better, xm, xb),
                           torch.where(better, xb, u)),
               torch.where(ul, torch.where(better, fa, fu),
                           torch.where(better, fm, fa)),
               torch.where(better, fu, fm),
               torch.where(ul, torch.where(better, fm, fb),
                           torch.where(better, fb, fu)),
               lam2, done2)
        xa, xm, xb, fa, fm, fb, lam, done = (
            torch.where(run, n, o) for n, o in zip(
                new, (xa, xm, xb, fa, fm, fb, lam, done)))

    cand_mu = torch.stack([mu_w, xa, xm, xb], -1)
    cand_f = torch.stack([f_w, fa, fm, fb], -1)
    i = torch.argmin(torch.where(torch.isfinite(cand_f), cand_f, torch.inf),
                     -1, keepdim=True)
    mu, val = cand_mu.gather(-1, i)[:, 0], cand_f.gather(-1, i)[:, 0]
    bad = ~(ok & torch.isfinite(val))
    return (torch.where(bad, B, mu), torch.where(bad, torch.inf, val), lam)


def _completion_times(sp, x, theta, active):
    """Back-substitution of ``completion_times`` with leaves that already
    broadcast against Θ (no per-job reshape)."""
    M = x.shape[-1]
    R = torch.triu(sp.s(theta))
    pair = active[..., :, None] & active[..., None, :]
    R = torch.where(pair, R, torch.eye(M, dtype=x.dtype, device=x.device))
    x = torch.where(active, x, 0.0)
    d = torch.linalg.solve_triangular(R, x[..., None], upper=True)[..., 0]
    d = torch.clamp_min(d, 0.0)
    # T[j] = Σ_{m ≥ j} d[m]  (phase M−1 is first in time)
    T = torch.flip(torch.cumsum(torch.flip(d, (-1,)), -1), (-1,))
    return d, T


def _solve(sp, x, w, B, m, coarse, descent_iters, cap_iters, fast,
           lam0=None, precise=True, with_times=True, stol_rel=None,
           bracket0=None):
    """Batch-first SmartFill core over iterations k = 1..M−1.

    Args:
      sp: speedup in x's dtype and on its device: shared, with
        per-instance (N,) leaves, or per job ((M,) or (N, M) leaves).
      x, w: (N, M) padded sizes/weights (padded entries 0).
      B: (N,) budgets.  m: (N,) count of live jobs (prefix 0..m−1);
        iterations k ≥ m are masked no-ops.
      coarse / descent_iters: minimizer sizes (grid points / descent
        steps).  cap_iters: λ-solve budget per CAP.
      fast: closed-form μ* for the pure-power family.
      lam0: optional (N, M) per-iteration λ* hints (a previous run's
        ``lam``); read on the per-job path only, and a hint outside the
        solver's validated bracket is ignored.
      precise: False relaxes the per-job minimizer at M < 33 to the
        large-instance settings (exit tolerance, window) and prices its
        grid with one cold solve a point; for re-planning where the
        allocations, not an oracle-pinned J, are the product.
      with_times: False skips durations, T and J (returned as zeros).
      stol_rel: the per-job descent's vertex exit (None: 3e-7 at
        M < 33 when ``precise``, else 1e-4).
      bracket0: optional (N, 2) λ-bracket (lo, hi) from a previous run's
        ``bracket``, seeding the generic path's carried bracket; each
        end is re-validated by the β-probes of ``solve_cap_generic``,
        so a stale one costs a cold solve, never a wrong one.

    Returns (theta (N, M, M), c, a, d, T (N, M), J, J_linear (N,),
    lam (N, M), bracket (N, 2)): lam[:, k] is iteration k's CAP dual λ*
    on the per-job path (0 elsewhere), bracket the carried generic-path
    λ-bracket, reusable as the next call's ``bracket0``.
    """
    N, M = x.shape
    dt, dev = x.dtype, x.device
    ln = _Lanes(sp, N, M)
    idx = torch.arange(M, device=dev)
    live0 = m > 0
    Wc = torch.cumsum(w, -1)           # Wc[:, k] = Σ w[:, :k+1]

    c = torch.zeros((N, M), dtype=dt, device=dev)
    a = torch.zeros((N, M), dtype=dt, device=dev)
    c[:, 0] = torch.where(live0, 1.0, 0.0).to(dt)
    a[:, 0] = torch.where(live0, w[:, 0] / ln.job(0).s(B), 0.0)
    cols = [torch.where((idx == 0) & live0[:, None], B[:, None], 0.0)]
    lams = [torch.zeros((N,), dtype=dt, device=dev)]
    # generic-path λ-bracket warm start, carried across iterations; the
    # full-range init is rejected by the first validation ("no hint")
    fi = torch.finfo(dt)
    warm = (torch.full((N,), fi.tiny / fi.eps, dtype=dt, device=dev),
            torch.full((N,), fi.max / 4.0, dtype=dt, device=dev))
    if bracket0 is not None:
        # a degenerate payload can at worst reproduce the cold init
        warm = tuple(torch.minimum(torch.maximum(bracket0[:, j], warm[0]),
                                   warm[1]) for j in (0, 1))
    closed = _uses_closed_cap(ln)
    sorted_cap = _uses_sorted_cap(ln)
    if sorted_cap:
        # the sorted CAP's breakpoint store, one job inserted an iteration
        bp = hetero_breakpoints_init(M, dt, dev, (N,))
        bp = hetero_breakpoints_insert(ln.jobs, c, 0, *bp, live=live0)
        small_m = precise and M < _APPROX_GRID_MIN_M
        # small instances are oracle-pinned to 1e-6 rel J: the full
        # 32-point grid, a tight vertex exit and a 5-point window; large
        # ones are certified by J == J_linear
        stol_eff = (3e-7 if small_m else 1e-4) if stol_rel is None \
            else stol_rel
        coarse_eff = max(coarse, 32) if small_m else coarse
        window = 5 if small_m else 3

    for k in range(1, M):
        live = k < m
        W = Wc[:, k]
        active = idx < k
        if sorted_cap:
            probes = _sorted_probes(ln, c, a, k, W, B, bp, cap_iters,
                                    precise)
            hint0 = (torch.zeros((N,), dtype=dt, device=dev) if lam0 is None
                     else lam0[:, k])
            mu, _, lam_mz = _minimize_f_hinted(
                *probes[:3], B, coarse_eff, descent_iters, hint0,
                stol_rel=stol_eff, window=window, live=live)
            th_rest, lam_k = probes[3](mu, lam_mz)
        else:
            F, cap = _make_f(ln, c, a, k, W, B, warm, cap_iters)
            if fast:
                # heSRPT closed form for s = aθ^p (m = 1/(1−p) = −1/γ),
                # clamped to the minimizer's domain: a zero-weight live
                # job gives μ = 0
                mexp = -1.0 / ln.job(k).gamma
                Wk = vpow(Wc[:, k], mexp)
                Wk1 = vpow(Wc[:, k - 1], mexp)
                mu = B * (Wk - Wk1) / torch.clamp_min(Wk, 1e-300)
                mu = torch.minimum(torch.maximum(mu, _mu_floor(B, dt)), B)
            else:
                mu, _ = _minimize_f(F, B, coarse, descent_iters)
            th_rest, warm2 = cap(mu)
            if not closed:
                # only a live iteration may move the carried warm bracket
                warm = (torch.where(live, warm2[0], warm[0]),
                        torch.where(live, warm2[1], warm[1]))
            lam_k = torch.zeros_like(mu)
        sp_k = ln.job(k)
        # (29): a_{k+1} = F(μ*), on the one CAP solve above; per job
        # (§7) each job is priced under its own s_i, the new one's
        # denominator and derivative are its own
        served = torch.where(active, a * ln.jobs.s(th_rest), 0.0)
        a_next = (W - served.sum(-1)) / sp_k.s(mu)
        col = torch.where(active, th_rest, 0.0)
        col = torch.where(idx == k, mu[:, None], col)
        # (28): c_{k+1} = c_k · s_k'(μ) / s_{k−1}'(θ_{k−1}); s'(0) < ∞
        # whenever a job can be parked
        c_next = (c[:, k - 1] * sp_k.ds(mu)
                  / ln.job(k - 1).ds(th_rest[:, k - 1]))
        c[:, k] = torch.where(live, torch.clamp_min(c_next, 1e-300), 0.0)
        a[:, k] = torch.where(live, a_next, 0.0)
        cols.append(torch.where(live[:, None], col, 0.0))
        lams.append(torch.where(live, lam_k, 0.0))
        if sorted_cap:
            bp = hetero_breakpoints_insert(ln.jobs, c, k, *bp, live=live)

    theta = torch.stack(cols, -1)
    active_jobs = idx < m[:, None]
    if with_times:
        d, T = _completion_times(ln.rows, x, theta, active_jobs)
        J = torch.where(active_jobs, w * T, 0.0).sum(-1)
    else:
        d = T = torch.zeros_like(x)
        J = torch.zeros((N,), dtype=dt, device=dev)
    J_lin = (a * x).sum(-1)
    return (theta, c, a, d, T, J, J_lin, torch.stack(lams, -1),
            torch.stack(warm, -1))


def completion_times(sp: Speedup, x, theta, active=None, device=None):
    """Back-substitute phase durations from Θ and sizes; return (d, T).

    x[j] = Σ_{m≥j} s(Θ[j,m])·d[m], solved from the earliest phase down.
    With ``active`` (a prefix mask of live jobs) padded rows/columns are
    replaced by the identity so d = T = 0 there.  Per-job leaves apply
    along rows of Θ.  Leading batch dimensions are allowed.
    """
    dev = resolve_device(device, theta, x, sp)
    theta = as_tensor(theta, dev)
    x = as_tensor(x, dev, theta.dtype)
    if active is None:
        active = torch.ones(x.shape, dtype=torch.bool, device=dev)
    active = as_tensor(active, dev, torch.bool)
    spr = rowwise(sp) if is_per_job(sp) else sp
    return _completion_times(spr, x, theta, active)


def objective(w, T):
    return torch.sum(torch.as_tensor(w, dtype=T.dtype, device=T.device) * T)


def _validate_instance(x, w):
    xs = np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
    ws = np.asarray(w.cpu() if isinstance(w, torch.Tensor) else w)
    if np.any(np.diff(xs) > 1e-12 * max(1.0, float(xs[0]))):
        raise ValueError("sizes must be non-increasing (x_1 ≥ … ≥ x_M)")
    if np.any(np.diff(ws) < -1e-12 * max(1.0, float(np.max(ws)))):
        raise ValueError("weights must be non-decreasing (w_1 ≤ … ≤ w_M)")


def _on(sp, dev, dtype):
    """``sp`` with its leaves on ``dev`` in ``dtype``."""
    return map_leaves(sp, lambda l: l.to(device=dev, dtype=dtype))




def _prepare_one(sp, x, w, B, device):
    """(sp, x, w, B) of a single-instance entry point on its device."""
    dev = resolve_device(device, x, sp)
    x = as_tensor(x, dev)
    w = as_tensor(w, dev, x.dtype)
    B = float(sp.B if B is None else B)
    return collapse_homogeneous(_on(sp, dev, x.dtype)), x, w, B


def _solve_one(sp, x, w, B, coarse, descent_iters, cap_iters, fast, **kw):
    """``_solve`` on one instance: N = 1, every job live."""
    M = int(x.shape[-1])
    out = _solve(sp, x[None], w[None],
                 torch.full((1,), B, dtype=x.dtype, device=x.device),
                 torch.full((1,), M, device=x.device), coarse,
                 descent_iters, cap_iters, fast, **kw)
    return tuple(o[0] for o in out)


def _schedule(out, cls=SmartFillSchedule, **extra):
    theta, c, a, d, T, J, J_lin = out[:7]
    return cls(theta=theta, c=c, a=a, durations=d, T=T, J=float(J),
               J_linear=float(J_lin), **extra)


def smartfill(
    sp: Speedup,
    x,
    w,
    B: float | None = None,
    coarse: int = 32,
    descent_iters: int = 40,
    validate: bool = True,
    cap_iters: int = 64,
    fast_path: bool | None = None,
    device=None,
) -> SmartFillSchedule:
    """Run SmartFill (Algorithm 2) on one instance.

    Args:
      sp: speedup (shared RegularSpeedup → closed-form CAP; per-job
        leaves (§7) → the sorted per-job CAP; otherwise the λ-bisection).
        A per-job speedup is solved in the *given* job order —
        ``smartfill_hetero`` also searches the completion order.
      x: (M,) job sizes, non-increasing.
      w: (M,) weights, non-decreasing.
      B: server bandwidth; defaults to sp.B.
      coarse / descent_iters: μ* minimizer sizes.
      cap_iters: λ-solve budget per CAP.
      fast_path: None auto-enables the closed-form μ* for shared pure
        power; False forces the descent minimizer.
      device: where to run; defaults to the inputs' device, else CUDA.

    The recursion runs in x's dtype (float64 for numpy input).
    """
    sp, x, w, B = _prepare_one(sp, x, w, B, device)
    if validate:
        _validate_instance(x, w)
    fast = _fast_ok(sp) and fast_path is not False
    return _schedule(_solve_one(sp, x, w, B, coarse, descent_iters,
                                cap_iters, fast))


def smartfill_allocations(sp: Speedup, rem, w, B: float | None = None,
                          device=None):
    """Current-instant optimal allocations for remaining sizes ``rem``:
    column M−1 of SmartFill on the remaining workload (rem non-increasing,
    w non-decreasing)."""
    sched = smartfill(sp, rem, w, B=B, validate=False, device=device)
    return sched.theta[:, -1]


@dataclasses.dataclass(frozen=True)
class WarmStart:
    """Cross-call warm-start payload for incremental re-planning.

    Produced by ``smartfill_warm`` and fed back to the next call on a
    related instance (one arrival or completion between solves, so λ*
    and the completion order barely move).  Both payloads are validated
    on use — ``lam`` per iteration against the solver's bracket,
    ``bracket`` by the β-probes of ``solve_cap_generic`` — so a stale
    payload costs a cold-priced solve, never a wrong one.

    lam: (M,) per-iteration CAP duals λ* (per-job path; zeros on the
      closed-form and bisection paths), tied to the producing call's M.
    bracket: (2,) final generic-path λ-bracket (lo, hi).
    order: optional host-side completion order the payload was produced
      under (row r held original job ``order[r]``); None when the caller
      manages the order itself.
    """

    lam: torch.Tensor
    bracket: torch.Tensor
    order: np.ndarray | None = None


def smartfill_warm(
    sp: Speedup,
    x,
    w,
    B: float | None = None,
    warm: WarmStart | None = None,
    coarse: int = 32,
    descent_iters: int = 40,
    cap_iters: int = 64,
    fast_path: bool | None = None,
    stol_rel: float | None = None,
    device=None,
) -> tuple[SmartFillSchedule, WarmStart]:
    """``smartfill`` with cross-call warm starts, for re-planning loops.

    Same contract as ``smartfill`` (x non-increasing, w non-decreasing),
    but the solve is seeded from ``warm`` (a previous call's per-iteration
    λ* hints and generic-path λ-bracket) and a fresh payload comes back
    with the schedule.  Hints only steer where the λ searches start, so
    the warm result matches the cold one to solver tolerance and a stale
    payload degrades to cold pricing.  The width M must match between
    the producing and the consuming call.
    """
    sp, x, w, B = _prepare_one(sp, x, w, B, device)
    M = int(x.shape[0])
    fast = _fast_ok(sp) and fast_path is not False
    kw = {}
    if warm is not None:
        lam0 = as_tensor(warm.lam, x.device, x.dtype)
        if lam0.shape != (M,):
            raise ValueError(
                f"warm.lam has shape {tuple(lam0.shape)}, instance is "
                f"padded to M={M}")
        kw = dict(lam0=lam0[None],
                  bracket0=as_tensor(warm.bracket, x.device, x.dtype)[None])
    out = _solve_one(sp, x, w, B, coarse, descent_iters, cap_iters, fast,
                     stol_rel=stol_rel, **kw)
    return _schedule(out), WarmStart(lam=out[7], bracket=out[8])


# ---------------------------------------------------------------------------
# Host-loop reference: the test oracle of the batch-first solver.  A
# Python loop over iterations with host-synced argmins and the original
# 512-point grid + grid-zoom μ* minimizer.
# ---------------------------------------------------------------------------

def _nanargmin(v) -> int:
    return int(torch.argmin(torch.where(torch.isnan(v), torch.inf, v)))


def _minimize_f_ref(sp, c, a, k, W, B, coarse=512, zoom_rounds=4,
                    zoom_pts=64):
    """Grid + grid-zoom argmin of F at iteration k; c, a (M,), W and B
    0-dim.  Returns (μ*, F(μ*))."""
    Bv, cv, av, Wv = B[None], c[None], a[None], W[None]
    lo = _mu_floor(Bv, c.dtype)
    # the log half excludes its B endpoint, as in ``_minimize_f``
    g1 = _geomspace(lo, Bv, coarse // 2 + 1)[:, :-1]
    g2 = _linspace(Bv / (coarse // 2), Bv, coarse // 2)
    mus = torch.sort(torch.cat([g1, g2], -1), -1).values
    vals = _f_grid(sp, mus, cv, av, k, Wv, Bv)[0]
    n = mus.shape[-1]
    i = _nanargmin(vals)
    mu_lo, mu_hi = mus[:, max(i - 1, 0)], mus[:, min(i + 1, n - 1)]
    for _ in range(zoom_rounds):
        mus = _linspace(mu_lo, mu_hi, zoom_pts)
        vals = _f_grid(sp, mus, cv, av, k, Wv, Bv)[0]
        i = _nanargmin(vals)
        mu_lo = mus[:, max(i - 1, 0)]
        mu_hi = mus[:, min(i + 1, zoom_pts - 1)]
    return mus[0, i], vals[i]


def smartfill_reference(
    sp: Speedup,
    x,
    w,
    B: float | None = None,
    coarse: int = 512,
    zoom_rounds: int = 4,
    validate: bool = True,
    device=None,
) -> SmartFillSchedule:
    """Original host-loop SmartFill (one host sync per zoom round).

    Slow but independently simple: the oracle of the batch-first solver
    and of the batched API.  Accepts per-job leaves (§7) in the given
    order (the diagonal terms use job k's own s_k), which makes it the
    fixed-order oracle behind ``smartfill_hetero_reference``.
    """
    dev = resolve_device(device, x, sp)
    x = as_tensor(x, dev)
    w = as_tensor(w, dev, x.dtype)
    sp = _on(sp, dev, x.dtype)
    M = int(x.shape[0])
    B = float(sp.B if B is None else B)
    if validate:
        _validate_instance(x, w)
    Bt = torch.tensor(B, dtype=x.dtype, device=dev)
    c = torch.zeros((M,), dtype=x.dtype, device=dev)
    a = torch.zeros_like(c)
    theta = torch.zeros((M, M), dtype=x.dtype, device=dev)
    c[0] = 1.0
    a[0] = w[0] / take_job(sp, 0).s(Bt)
    theta[0, 0] = B
    idx = torch.arange(M, device=dev)
    for k in range(1, M):
        W = w[: k + 1].sum()
        mu, a_next = _minimize_f_ref(sp, c, a, k, W, Bt, coarse, zoom_rounds)
        active = idx < k
        th_rest = solve_cap(sp, Bt - mu, c, active)
        theta[:, k] = torch.where(active, th_rest, 0.0)
        theta[k, k] = mu
        ds_prev = take_job(sp, k - 1).ds(th_rest[k - 1])
        c_next = c[k - 1] * take_job(sp, k).ds(mu) / ds_prev
        c[k] = torch.clamp_min(c_next, 1e-300)
        a[k] = a_next
    d, T = completion_times(sp, x, theta)
    return SmartFillSchedule(theta=theta, c=c, a=a, durations=d, T=T,
                             J=float(objective(w, T)),
                             J_linear=float((a * x).sum()))


# ---------------------------------------------------------------------------
# Per-job speedups (paper §7): SmartFill + completion-order search.  Thm 10
# keeps the CDR rule under per-job s_i; the optimal completion order is
# open, so the planner starts from SJF by normalized size and refines with
# exchanges, and the host oracle can brute-force small instances.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class HeteroSmartFillSchedule(SmartFillSchedule):
    """A SmartFillSchedule whose rows follow a searched completion order.

    ``order[r]`` is the original job index in schedule row r (row 0
    completes last, row M−1 first).  theta/c/a/durations/T are in row
    order; map back with ``T[np.argsort(order)]`` etc.
    """

    order: np.ndarray


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().astype(np.float64)
    return np.asarray(x, dtype=np.float64)


def _solo_order(x, w, rate) -> np.ndarray:
    """Rows by solo full-server completion time x_i / s_i(B), descending,
    ties by weight ascending (numpy, one instance)."""
    t_solo = x / np.maximum(rate, 1e-300)
    return np.lexsort((w, -t_solo))


def normalized_order(sp: Speedup, x, w, B: float | None = None) -> np.ndarray:
    """SJF-by-normalized-size completion order for per-job speedups.

    Jobs are ranked by solo full-server completion time x_i / s_i(B) —
    descending, ties by weight ascending — so the job that would finish
    first alone completes first (row M−1).  For a shared speedup this is
    the paper's size order.  One device call for the rates, then host
    numpy.
    """
    x, w = _host(x), _host(w)
    M = x.shape[0]
    B = float(sp.B if B is None else B)
    rate = np.broadcast_to(host_call(sp, "s", np.full(M, B)), (M,))
    return _solo_order(x, w, rate)


def _permute_speedup(sp, perm):
    """Reorder job-indexed leaves along their last axis (a (P, M) index
    array gives (P, M) leaves); shared scalar leaves are untouched."""
    def take(l):
        return l[torch.as_tensor(perm, device=l.device)] if l.ndim else l
    return map_leaves(sp, take)


def _exchange_candidates(order, window):
    """All single-swap neighbours of ``order`` within pair distance ≤ window.

    Returns an (n_cand, M) index array; ``window=1`` gives the M−1
    adjacent swaps, larger windows add the non-adjacent pairs within
    that distance.  The count depends only on (M, window).
    """
    order = np.asarray(order)
    n = int(order.shape[0])
    cands = []
    for i in range(n - 1):
        for j in range(i + 1, min(i + int(window), n - 1) + 1):
            cand = order.copy()
            cand[i], cand[j] = cand[j], cand[i]
            cands.append(cand)
    if not cands:
        return np.zeros((0, n), dtype=order.dtype)
    return np.stack(cands)


def _exchange_descent(run, order, passes, window=1):
    """Steepest-descent exchange search on the completion order.

    ``run(perm) → (result, J)``.  Each step scores every swap within
    ``window`` and takes the best one iff it improves J by more than a
    1e-10 relative margin; at most ``passes·(M−1)`` steps.  Ties go to
    the first candidate, as in the batched search.
    """
    order = np.asarray(order)
    best, best_J = run(order)
    steps = max(int(passes), 0) * max(int(order.shape[0]) - 1, 1)
    for _ in range(steps):
        cands = _exchange_candidates(order, window)
        if cands.shape[0] == 0:
            break
        outs = []
        Js = np.empty(cands.shape[0])
        for t in range(cands.shape[0]):
            out, J = run(cands[t])
            outs.append(out)
            Js[t] = J if np.isfinite(J) else np.inf
        j = int(np.argmin(Js))
        if Js[j] < best_J * (1.0 - 1e-10):
            order, best, best_J = cands[j], outs[j], float(Js[j])
        else:
            break
    return order, best, best_J


def _exchange_descent_batched(run_one, score, order, passes, window):
    """The search of ``_exchange_descent`` with each step's candidates
    scored in one batched solve.

    ``score(perms, lam0) → (J, lam)`` prices an (n_cand, M) array of
    orders, every candidate warm-started from the incumbent's λ* (one
    swap barely moves it).  A step syncs the host once, for the winning
    index and the accept flag together; the incumbent J stays on the
    device.  The final order is re-solved without hints through
    ``run_one``, so the schedule is the sequential search's.
    """
    order = np.asarray(order)
    out = run_one(order)
    best_J, lam0 = out[5], out[7]
    steps = max(int(passes), 0) * max(int(order.shape[0]) - 1, 1)
    moved = False
    for _ in range(steps):
        cands = _exchange_candidates(order, window)
        if cands.shape[0] == 0:
            break
        Js, lams = score(cands, lam0)
        Js = torch.where(torch.isfinite(Js), Js, torch.inf)
        j_dev = torch.argmin(Js)
        J_cand = Js[j_dev]
        accept = torch.isfinite(J_cand) & (J_cand < best_J * (1.0 - 1e-10))
        j, acc = torch.stack([j_dev.to(Js.dtype),
                              accept.to(Js.dtype)]).tolist()  # one sync
        if acc:
            order, best_J, lam0, moved = cands[int(j)], J_cand, lams[j_dev], True
        else:
            break
    if moved:
        out = run_one(order)
    return order, out, float(out[5])


def smartfill_hetero(
    sp: Speedup,
    x,
    w,
    B: float | None = None,
    coarse: int = 24,
    descent_iters: int = 40,
    cap_iters: int = 64,
    exchange_passes: int = 2,
    exchange_window: int = 1,
    batched_exchange: bool = True,
    fast_path: bool | None = None,
    stol_rel: float | None = None,
    device=None,
) -> HeteroSmartFillSchedule:
    """SmartFill with per-job speedup functions (paper §7).

    Args:
      sp: per-job speedup — an (M,)-leaved ``RegularSpeedup``, a
        ``StackedSpeedup`` (mixing σ=±1 families), or a shared speedup
        (then this is ``smartfill`` on size-ordered inputs).
      x, w: (M,) job sizes / weights in any order: the completion order
        is part of the decision here.
      exchange_passes: step budget of the exchange search over the
        SJF-by-normalized-size order, as a multiple of M−1 steps.  Each
        step scores every swap within ``exchange_window`` and takes the
        best improvement; 0 plans the heuristic order as it is.
      exchange_window: maximum pair distance of a candidate swap (1:
        adjacent exchanges; k > 1 adds the pairs within distance k,
        which escapes stalls of non-agreeable instances).
      batched_exchange: score a step's candidates in one batched
        ``_solve`` (λ* warm-started from the incumbent, one host sync a
        step).  False runs the sequential per-candidate loop, the
        differential reference.
      stol_rel: override of the μ* descent's vertex exit (see ``_solve``).
      device: where to run; defaults to the inputs' device, else CUDA.

    Returns a HeteroSmartFillSchedule; ``.order`` maps schedule rows back
    to the caller's job indices.  ``J == J_linear`` (to rounding)
    certifies that the returned order is realized exactly (Prop. 9
    carried into §7): an order the recursion cannot realize shows up as
    negative raw durations, which back-substitution clamps, inflating J
    above J_linear, so the search, which minimizes the executed J,
    avoids such orders.
    """
    for leaf in leaves(sp):
        if leaf.ndim >= 1 and leaf.shape[0] != len(x):
            raise ValueError(
                f"per-job speedup leaf has {leaf.shape[0]} entries for "
                f"{len(x)} jobs")
    sp, x, w, B = _prepare_one(sp, x, w, B, device)
    M = int(x.shape[0])
    fast = _fast_ok(sp) and fast_path is not False

    def solve(perms, lam0=None):
        p = torch.as_tensor(perms, device=x.device)
        P = p.shape[0]
        return _solve(_permute_speedup(sp, p), x[p], w[p],
                      torch.full((P,), B, dtype=x.dtype, device=x.device),
                      torch.full((P,), M, device=x.device), coarse,
                      descent_iters, cap_iters, fast, lam0=lam0,
                      stol_rel=stol_rel)

    def run_one(perm):
        return tuple(o[0] for o in solve(np.asarray(perm)[None]))

    init = normalized_order(sp, x, w, B)
    if batched_exchange and exchange_passes > 0 and M > 1:
        def score(perms, lam0):
            out = solve(perms, lam0.expand(len(perms), M))
            return out[5], out[7]

        order, best, _ = _exchange_descent_batched(
            run_one, score, init, exchange_passes, exchange_window)
    else:
        def run(perm):
            out = run_one(perm)
            return out, float(out[5])

        order, best, _ = _exchange_descent(run, init, exchange_passes,
                                           exchange_window)
    return _schedule(best, HeteroSmartFillSchedule, order=np.asarray(order))


def smartfill_hetero_reference(
    sp: Speedup,
    x,
    w,
    B: float | None = None,
    search: str = "auto",
    max_brute: int = 5,
    coarse: int = 512,
    zoom_rounds: int = 4,
    exchange_passes: int = 2,
    exchange_window: int = 1,
    device=None,
) -> HeteroSmartFillSchedule:
    """Host-loop oracle for per-job SmartFill.

    Runs ``smartfill_reference`` over candidate completion orders and
    keeps the best J: ``search="brute"`` (or "auto" with M ≤
    ``max_brute``) tries every permutation, the order ground truth on
    small instances; otherwise the planner's exchange search, driven by
    the host solver.
    """
    if search not in ("auto", "brute", "exchange"):
        raise ValueError("search must be 'auto', 'brute' or 'exchange'")
    dev = resolve_device(device, x, sp)
    x = as_tensor(x, dev)
    w = as_tensor(w, dev, x.dtype)
    M = int(x.shape[0])
    B = float(sp.B if B is None else B)
    sp = collapse_homogeneous(_on(sp, dev, x.dtype))

    def run(perm):
        p = torch.as_tensor(np.asarray(perm), device=dev)
        sched = smartfill_reference(
            _permute_speedup(sp, p), x[p], w[p], B=B, coarse=coarse,
            zoom_rounds=zoom_rounds, validate=False)
        return sched, sched.J

    if search == "brute" or (search == "auto" and M <= max_brute):
        best, best_J, order = None, np.inf, None
        for perm in itertools.permutations(range(M)):
            sched, J = run(perm)
            if np.isfinite(J) and J < best_J:
                best, best_J, order = sched, J, np.asarray(perm)
    else:
        order, best, _ = _exchange_descent(
            run, normalized_order(sp, x, w, B), exchange_passes,
            exchange_window)
    return HeteroSmartFillSchedule(
        theta=best.theta, c=best.c, a=best.a, durations=best.durations,
        T=best.T, J=best.J, J_linear=best.J_linear, order=np.asarray(order))
