"""heSRPT — the baseline policy of Berg, Vesilo & Harchol-Balter (2020).

heSRPT is the *optimal* policy when the speedup function is a pure power
law ``s(θ) = a θ^p`` (0 < p < 1).  Its allocations are scale-free — they
depend only on the weights, not the sizes (Theorem 3 in [2]): when the k
largest-remaining jobs 1..k are active (sizes non-increasing, weights
non-decreasing),

    θ_i / B = (W_i^{1/(1−p)} − W_{i−1}^{1/(1−p)}) / W_k^{1/(1−p)},
    W_i = Σ_{j ≤ i} w_j,  W_0 = 0.

Sanity limits: p → 1 gives pure SRPT (everything to the smallest job);
p → 0 gives allocation ∝ w_i.

For general concave s the paper's benchmark ("approximation-based
heSRPT") first fits s with ``ã θ^p̃`` and then runs the closed form under
the fitted exponent, re-planning at completion events while the *true* s
drives the dynamics.  ``fit_power`` reproduces the paper's fits
(0.79 θ^0.48 for log(1+θ); 0.26 θ^0.82 for √(4+θ)−2 on [0, 10]).
"""
from __future__ import annotations

import numpy as np

from .speedup import host_call

__all__ = [
    "hesrpt_allocations",
    "hesrpt_policy",
    "hesrpt_open_loop",
    "fit_power",
]


def hesrpt_allocations(w, p: float, B: float) -> np.ndarray:
    """Closed-form heSRPT shares for active jobs with weights ``w``.

    ``w`` must be aligned with jobs sorted by remaining size
    non-increasing (so w is non-decreasing).  Returns allocations summing
    to B.  Note the shares do not depend on ``a`` or the sizes.
    """
    w = np.asarray(w, dtype=np.float64)
    m = 1.0 / (1.0 - p)
    W = np.cumsum(w)
    Wm = np.concatenate([[0.0], W]) ** m
    return B * (Wm[1:] - Wm[:-1]) / Wm[-1]


def hesrpt_policy(p: float, B: float):
    """Policy closure for the event-driven simulator.

    policy(rem, w, active) → full-length allocation vector.  Active jobs
    are ranked by remaining size (desc; ties by weight asc) and receive
    the closed-form heSRPT shares.
    """

    def policy(rem, w, active):
        rem = np.asarray(rem, dtype=np.float64)
        w = np.asarray(w, dtype=np.float64)
        theta = np.zeros_like(rem)
        idx = np.flatnonzero(active)
        if idx.size == 0:
            return theta
        # sort: largest remaining first; stable tie-break by weight asc
        order = idx[np.lexsort((w[idx], -rem[idx]))]
        theta[order] = hesrpt_allocations(w[order], p, B)
        return theta

    return policy


def hesrpt_open_loop(sp_true, x, w, p: float, a: float, B: float,
                     rtol: float = 1e-12):
    """Open-loop approximation-based heSRPT (paper §6.2 benchmark).

    The schedule — phase allocations *and* phase boundaries — is computed
    once under the fitted model ``s̃(θ) = a θ^p`` and then executed over
    wall-clock time while the *true* speedup drives the dynamics.  When a
    job completes earlier than planned its bandwidth idles until the next
    planned phase boundary; a job still unfinished when the plan says it
    is done receives nothing until the plan's horizon, after which the
    leftovers are drained with event-driven heSRPT.

    This is the pessimistic reading of "apply heSRPT with an approximate
    s"; the event-driven reading is ``hesrpt_policy`` + simulate_policy.
    Together they bracket any reasonable heSRPT implementation.
    """
    x = np.asarray(x, dtype=np.float64)
    w = np.asarray(w, dtype=np.float64)
    M = x.shape[0]

    # --- plan under the fitted model (jobs sorted: x non-increasing) ----
    alloc = np.zeros((M, M))            # alloc[i, j]: rate of job i, phase j
    for j in range(M):                  # phase j has jobs 0..j active
        alloc[: j + 1, j] = hesrpt_allocations(w[: j + 1], p, B)
    s_fit = lambda t: a * np.maximum(t, 0.0) ** p
    rate_fit = np.where(np.triu(np.ones((M, M))) > 0, s_fit(alloc), 0.0)
    # planned durations: x = R d (upper-triangular back-substitution)
    d_plan = np.zeros(M)
    for jj in range(M - 1, -1, -1):
        served = rate_fit[jj, jj + 1:] @ d_plan[jj + 1:]
        d_plan[jj] = max(x[jj] - served, 0.0) / max(rate_fit[jj, jj], 1e-300)

    # --- execute under the true speedup --------------------------------
    rem = x.copy()
    T = np.zeros(M)
    t = 0.0
    tol = rtol * max(1.0, float(x.max()))
    for j in range(M - 1, -1, -1):      # planned phases, earliest first
        seg = d_plan[j]
        theta = alloc[:, j]
        rates = host_call(sp_true, "s", theta)
        while seg > 0:
            active = rem > tol
            runnable = active & (rates > 0)
            if not runnable.any():
                break
            dts = rem[runnable] / rates[runnable]
            dt = min(float(dts.min()), seg)
            rem = np.maximum(rem - rates * dt * (rem > tol), 0.0)
            t += dt
            seg -= dt
            done = active & (rem <= tol)
            T[done] = t
            rem[done] = 0.0
    # --- drain leftovers (plan horizon exhausted) -----------------------
    if (rem > tol).any():
        from .simulator import simulate_policy

        left = rem > tol
        idx = np.flatnonzero(left)
        sub = simulate_policy(sp_true, rem[idx], w[idx],
                              hesrpt_policy(p, B), B=B, rtol=rtol)
        T[idx] = t + sub.T
    return T, float(np.sum(w * T))


def fit_power(s_fn, B: float, n: int = 1024, theta_min: float = 1e-2,
              method: str = "linear"):
    """Least-squares fit  s(θ) ≈ a θ^p  on (0, B].

    ``method='linear'`` minimizes Σ (a θ^p − s(θ))² — this reproduces the
    paper's fits (Fig. 7: 0.79 θ^0.48 for log(1+θ); Fig. 9: 0.26 θ^0.82
    for √(4+θ)−2).  ``method='loglog'`` is the classic log-space fit.
    Used to build the approximation-based heSRPT benchmark.
    """
    th = np.linspace(theta_min, B, n)
    sv = np.array([float(s_fn(t)) for t in th])
    if method == "loglog":
        lx, ly = np.log(th), np.log(sv)
        p = float(np.cov(lx, ly, bias=True)[0, 1] / np.var(lx))
        a = float(np.exp(np.mean(ly) - p * np.mean(lx)))
        return a, p
    # grid over p with analytic a per p, then golden-zoom refine
    lo, hi = 0.02, 0.999

    def err_a(p):
        X = th ** p
        a = float(X @ sv / (X @ X))
        return float(np.sum((a * X - sv) ** 2)), a

    for _ in range(6):
        ps = np.linspace(lo, hi, 64)
        errs = [err_a(p)[0] for p in ps]
        i = int(np.argmin(errs))
        lo, hi = ps[max(i - 1, 0)], ps[min(i + 1, len(ps) - 1)]
    p = 0.5 * (lo + hi)
    return err_a(p)[1], p
