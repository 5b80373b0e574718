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
                 θ^{k+1}_{k+1} = μ*;  θ^{k+1}_i = CAP_i(B−μ*, c)
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

Per-job speedups (paper §7: ``smartfill_hetero``, the hinted minimizer,
the breakpoint store) and the warm-start knobs of ``smartfill_warm`` are
not ported yet; a per-job speedup raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import as_tensor, resolve_device
from .gwf import (solve_cap, solve_cap_generic, waterfill_prepare,
                  waterfill_solve, waterfill_solve_many)
from .speedup import (RegularSpeedup, Speedup, collapse_homogeneous,
                      inner_per_job, is_per_job, map_leaves, per_instance,
                      rowwise)

__all__ = [
    "SmartFillSchedule",
    "smartfill",
    "smartfill_allocations",
    "completion_times",
    "objective",
]

_PER_JOB_LATER = (
    "per-job speedups (paper §7) run through smartfill_hetero and the "
    "sorted per-job SmartFill path, which come with the next slice of "
    "the PyTorch port")


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
    return 10.0 ** _linspace(torch.log10(start), torch.log10(stop), num)


def _lanes(sp, N):
    """Views of ``sp`` that broadcast against (N,), (N, ·) and (N, ·, ·)."""
    return tuple(per_instance(sp, N, nd) for nd in range(3))


def _f_grid(sp, mus, c, a, k, W, B):
    """F(μ) over a grid for every instance: mus (N, G) → (N, G).

    c/a are (N, M) with the first k entries live; ``sp`` is shared (or
    has per-instance leaves).  The one-shot form of the priced grid
    used by the minimizer.
    """
    N, M = c.shape
    G = mus.shape[-1]
    _, sp1, sp2 = _lanes(sp, N)
    active = (torch.arange(M, device=c.device) < k).expand(N, G, M)
    th = solve_cap(sp2, B[:, None] - mus, c[:, None, :].expand(N, G, M),
                   active)
    served = torch.where(active, a[:, None, :] * sp2.s(th), 0.0).sum(-1)
    return (W[:, None] - served) / sp1.s(mus)


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


def _uses_closed_cap(sp: Speedup, N: int) -> bool:
    """Can the CAP use the prefix-sum closed form?  Only a shared (per
    instance) RegularSpeedup has the common auxiliary curve it needs."""
    return isinstance(sp, RegularSpeedup) and not inner_per_job(sp, N)


def _make_f(lanes, c, a, k, W, B, warm, cap_iters):
    """Build (F, cap) for one SmartFill iteration over N instances.

    ``F(μ)`` prices (N, P) candidate μ at once and returns (N, P);
    ``cap(μ)`` solves the CAP at the chosen (N,) μ* and returns
    ``(θ, λ-bracket)``.  On the closed-form path the water-filling curve
    is factorized once here (its sort depends on c only), so every
    budget costs O(k).  Otherwise each F evaluation is a λ-bisection
    warm-started from the carried bracket (widened once here) with the
    adaptive exit, and cap runs the full-precision bisection and returns
    the bracket to carry forward.
    """
    sp0, sp1, sp2 = lanes
    N, M = c.shape
    active = (torch.arange(M, device=c.device) < k).expand(N, M)

    def price(th, mu):
        # th (N, P, M), mu (N, P)
        served = torch.where(active[:, None, :], a[:, None, :] * sp2.s(th),
                             0.0).sum(-1)
        return (W[:, None] - served) / sp1.s(mu)

    if _uses_closed_cap(sp0, N):
        u = torch.where(active, sp1.bottle_width(c), 0.0)
        h0 = sp1.bottle_bottom(c)
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
            sp2, B[:, None] - mu, c[:, None, :].expand(N, P, M),
            active[:, None, :].expand(N, P, M), iters=cap_iters,
            bracket=(bracket[0][:, None].expand(N, P),
                     bracket[1][:, None].expand(N, P)),
            rel_tol=_CAP_REL_TOL)
        return price(th, mu)

    def cap(mu):
        return solve_cap_generic(sp1, B - mu, c, active, iters=96,
                                 bracket=bracket, return_bracket=True)
    return F, cap


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


def _solve(sp, x, w, B, m, coarse, descent_iters, cap_iters, fast):
    """Batch-first SmartFill core over iterations k = 1..M−1.

    Args:
      sp: shared speedup, or one with per-instance (N,) leaves, in x's
        dtype and on its device.
      x, w: (N, M) padded sizes/weights (padded entries 0).
      B: (N,) budgets.  m: (N,) count of live jobs (prefix 0..m−1);
        iterations k ≥ m are masked no-ops.
      coarse / descent_iters: minimizer sizes (grid points / golden
        iterations).  cap_iters: λ-bisection budget per generic F.
      fast: closed-form μ* for the pure-power family.

    Returns (theta (N, M, M), c, a, d, T (N, M), J, J_linear (N,)).
    """
    N, M = x.shape
    dt, dev = x.dtype, x.device
    lanes = _lanes(sp, N)
    sp0, sp1, sp2 = lanes
    idx = torch.arange(M, device=dev)
    live0 = m > 0
    Wc = torch.cumsum(w, -1)           # Wc[:, k] = Σ w[:, :k+1]

    c = torch.zeros((N, M), dtype=dt, device=dev)
    a = torch.zeros((N, M), dtype=dt, device=dev)
    c[:, 0] = torch.where(live0, 1.0, 0.0).to(dt)
    a[:, 0] = torch.where(live0, w[:, 0] / sp0.s(B), 0.0)
    cols = [torch.where((idx == 0) & live0[:, None], B[:, None], 0.0)]
    # generic-path λ-bracket warm start, carried across iterations; the
    # full-range init is rejected by the first validation ("no hint")
    fi = torch.finfo(dt)
    warm = (torch.full((N,), fi.tiny / fi.eps, dtype=dt, device=dev),
            torch.full((N,), fi.max / 4.0, dtype=dt, device=dev))
    closed = _uses_closed_cap(sp, N)

    for k in range(1, M):
        live = k < m
        W = Wc[:, k]
        active = idx < k
        F, cap = _make_f(lanes, c, a, k, W, B, warm, cap_iters)
        if fast:
            # heSRPT closed form for s = aθ^p (m = 1/(1−p) = −1/γ), clamped
            # to the minimizer's domain: a zero-weight live job gives μ = 0
            mexp = -1.0 / sp0.gamma
            Wk = Wc[:, k] ** mexp
            Wk1 = Wc[:, k - 1] ** mexp
            mu = B * (Wk - Wk1) / torch.clamp_min(Wk, 1e-300)
            mu = torch.minimum(torch.maximum(mu, _mu_floor(B, dt)), B)
        else:
            mu, _ = _minimize_f(F, B, coarse, descent_iters)
        th_rest, warm2 = cap(mu)
        if not closed:
            # only a live iteration may move the carried warm bracket
            warm = (torch.where(live, warm2[0], warm[0]),
                    torch.where(live, warm2[1], warm[1]))
        # (29): a_{k+1} = F(μ*), on the one CAP solve above
        served = torch.where(active, a * sp1.s(th_rest), 0.0)
        a_next = (W - served.sum(-1)) / sp0.s(mu)
        col = torch.where(active, th_rest, 0.0)
        col = torch.where(idx == k, mu[:, None], col)
        # (28): c_{k+1} = c_k · s'(μ) / s'(θ_{k−1}); s'(0) < ∞ whenever a
        # job can be parked
        c_next = c[:, k - 1] * sp0.ds(mu) / sp0.ds(th_rest[:, k - 1])
        c[:, k] = torch.where(live, torch.clamp_min(c_next, 1e-300), 0.0)
        a[:, k] = torch.where(live, a_next, 0.0)
        cols.append(torch.where(live[:, None], col, 0.0))

    theta = torch.stack(cols, -1)
    active_jobs = idx < m[:, None]
    d, T = _completion_times(sp2, x, theta, active_jobs)
    J = torch.where(active_jobs, w * T, 0.0).sum(-1)
    J_lin = (a * x).sum(-1)
    return theta, c, a, d, T, J, J_lin


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
      sp: shared speedup (RegularSpeedup → closed-form CAP; otherwise the
        λ-bisection path).  Per-job speedups are not ported yet.
      x: (M,) job sizes, non-increasing.
      w: (M,) weights, non-decreasing.
      B: server bandwidth; defaults to sp.B.
      coarse / descent_iters: μ* minimizer sizes.
      cap_iters: λ-bisection budget per generic-path F evaluation.
      fast_path: None auto-enables the closed-form μ* for shared pure
        power; False forces the descent minimizer.
      device: where to run; defaults to the inputs' device, else CUDA.

    The recursion runs in x's dtype (float64 for numpy input).
    """
    dev = resolve_device(device, x, sp)
    x = as_tensor(x, dev)
    w = as_tensor(w, dev, x.dtype)
    M = int(x.shape[0])
    B = float(sp.B if B is None else B)
    if validate:
        _validate_instance(x, w)
    sp = collapse_homogeneous(_on(sp, dev, x.dtype))
    if is_per_job(sp):
        raise NotImplementedError(_PER_JOB_LATER)
    fast = _fast_ok(sp) and fast_path is not False
    theta, c, a, d, T, J, J_lin = _solve(
        sp, x[None], w[None], torch.full((1,), B, dtype=x.dtype, device=dev),
        torch.full((1,), M, device=dev), coarse, descent_iters, cap_iters,
        fast)
    return SmartFillSchedule(theta=theta[0], c=c[0], a=a[0], durations=d[0],
                             T=T[0], J=float(J[0]), J_linear=float(J_lin[0]))


def smartfill_allocations(sp: Speedup, rem, w, B: float | None = None,
                          device=None):
    """Current-instant optimal allocations for remaining sizes ``rem``:
    column M−1 of SmartFill on the remaining workload (rem non-increasing,
    w non-decreasing)."""
    sched = smartfill(sp, rem, w, B=B, validate=False, device=device)
    return sched.theta[:, -1]
