"""CDR Rule verification — Theorems 1, 2 and Corollary 2.1 (host numpy).

Given an upper-triangular schedule Θ (as produced by SmartFill, or any
candidate policy in scheduling-matrix form), verify:

  (Thm 1 / Cor 2.1)  for every pair of jobs (i, l) and every pair of
    phases where both receive positive rate, s'(θ_i)/s'(θ_l) is the same
    constant c_i/c_l;
  (Thm 2)  in a phase where job i is active-but-parked (θ_i = 0) and job
    l runs (θ_l > 0, with i < l so c_i ≥ c_l), the constant satisfies
    c_l/c_i ≤ s'(θ_l)/s'(0).

This is the test oracle for the structural property; it is how we check
that SmartFill's output (and any optimized schedule from brute force)
has the shape the theory demands.
"""
from __future__ import annotations

import numpy as np
import torch

from .speedup import host_call

__all__ = ["cdr_violation", "estimate_constants"]


def _host(theta) -> np.ndarray:
    if isinstance(theta, torch.Tensor):
        theta = theta.detach().cpu().numpy()
    return np.asarray(theta, dtype=np.float64)


def estimate_constants(sp, theta, tol: float = 1e-9) -> np.ndarray:
    """Estimate the Cor. 2.1 constants c_i from a schedule.

    c_0 := 1; c_i := s'(θ_i^j)/s'(θ_0^j) · c_0 for the first phase j where
    both are positive, chained through intermediaries when needed.
    """
    theta = _host(theta)
    M = theta.shape[0]
    ds = host_call(sp, "ds", theta)
    c = np.full(M, np.nan)
    c[0] = 1.0
    # iterate until closure (handles chains through intermediaries)
    for _ in range(M):
        for i in range(M):
            if np.isfinite(c[i]):
                continue
            for j in range(i, M):  # phases where job i is active
                if theta[i, j] <= tol:
                    continue
                for l in range(j + 1):
                    if l != i and np.isfinite(c[l]) and theta[l, j] > tol:
                        c[i] = c[l] * ds[i, j] / ds[l, j]
                        break
                if np.isfinite(c[i]):
                    break
    return c


def cdr_violation(sp, theta, tol: float = 1e-9) -> dict:
    """Max relative violation of the CDR rule by schedule Θ.

    Returns dict with:
      'ratio': Thm 1 — max over job pairs of (max ratio − min ratio)/max,
        where the ratio s'(θ_i)/s'(θ_l) is collected over phases with
        both positive.
      'park':  Thm 2 — max over parked-job events of
        max(0, c_l/c_i − s'(θ_l)/s'(0)).
    """
    theta = _host(theta)
    M = theta.shape[0]
    ds = host_call(sp, "ds", theta)
    ds0 = float(host_call(sp, "ds0"))

    ratio_viol = 0.0
    for i in range(M):
        for l in range(i + 1, M):
            ratios = []
            for j in range(l, M):  # phases where both i and l are active
                if theta[i, j] > tol and theta[l, j] > tol:
                    ratios.append(ds[i, j] / ds[l, j])
            if len(ratios) >= 2:
                r = np.array(ratios)
                ratio_viol = max(ratio_viol, float((r.max() - r.min()) / r.max()))

    park_viol = 0.0
    if np.isfinite(ds0):
        c = estimate_constants(sp, theta, tol)
        for j in range(M):
            for i in range(j + 1):      # i active in phase j
                if theta[i, j] > tol or not np.isfinite(c[i]):
                    continue
                for l in range(i + 1, j + 1):  # i < l, c_i ≥ c_l
                    if theta[l, j] > tol and np.isfinite(c[l]):
                        lhs = c[l] / c[i]
                        rhs = ds[l, j] / ds0
                        park_viol = max(park_viol, float(lhs - rhs))
    return {"ratio": ratio_viol, "park": park_viol}
