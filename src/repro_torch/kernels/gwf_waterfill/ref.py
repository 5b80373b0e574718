"""Plain PyTorch versions of the three water-filling kernels.

``gwf_waterfill_ref``      — the exact piecewise-linear WFP solve of
                             ``core/gwf.py`` (sort + prefix sums) on
                             (u, h0) inputs.
``generic_waterfill_ref``  — the batched λ-bisection for one shared
                             regular family s'(θ) = A(w + σθ)^γ.
``hetero_waterfill_ref``   — the per-job variant (paper §7): A, w, γ and
                             σ are (N, K) job-indexed arrays.

They are what the CUDA kernels are held against on the card, and what
the wrappers run when handed CPU tensors.  They compute in the dtype
they are given.
"""
from __future__ import annotations

import torch

from ..._device import stops_early
from ...core.gwf import waterfill_level

__all__ = ["lam_bracket", "hetero_lam_bracket", "gwf_waterfill_ref",
           "generic_waterfill_ref", "hetero_waterfill_ref"]

_BIG = 1e30
_INF = float("inf")


def gwf_waterfill_ref(u, h0, b):
    """Exact piecewise-linear WFP solve.  u, h0 (M,); scalar b."""
    dt = torch.float64 if u.dtype == torch.float64 else torch.float32
    u = u.to(dt)
    h0 = h0.to(dt)
    b = torch.as_tensor(b, dtype=dt, device=u.device)
    active = u > 0
    h = waterfill_level(u, h0, b, active)
    return torch.where(active,
                       torch.minimum(torch.clamp_min(u * (h - h0), 0.0), b),
                       0.0)


def lam_bracket(c, A, w, gamma, b, sigma):
    """Safe λ-bisection bracket per instance of the regular family.

    c is (N, K); A, w, gamma, b are (N,).  λ ∈ [s'(b)/max c, s'(0⁺)/min c]
    with s'(ε), ε = b/(8K), standing in for an infinite s'(0).  Returns
    (lam_lo, lam_hi, ds0), each (N,); ds0 = s'(0) is capped at 1e30 so it
    stays float32-representable.
    """
    k = c.shape[-1]
    active = c > 0
    c_hi = torch.where(active, c, -_INF).amax(-1)
    c_lo = torch.where(active, c, _INF).amin(-1)

    def ds(t):
        return A * (w + sigma * t) ** gamma

    ds_b = ds(b)
    eps = b / (8.0 * k)
    ds0 = torch.where(w > 0, A * torch.clamp_min(w, 1e-300) ** gamma, _BIG)
    ds_top = torch.where(w > 0, ds0, ds(eps))
    lam_lo = ds_b / c_hi
    lam_hi = ds_top / c_lo * (1.0 + 1e-6)
    lam_hi = torch.maximum(lam_hi, lam_lo * (1.0 + 1e-6))
    # degenerate (no active jobs): any positive bracket keeps logs finite
    good = torch.isfinite(lam_lo) & (lam_lo > 0) & torch.isfinite(lam_hi)
    return (torch.where(good, lam_lo, 1.0), torch.where(good, lam_hi, 2.0),
            ds0)


def hetero_lam_bracket(c, A, w, gamma, sigma, b):
    """Per-job λ-bisection bracket (paper §7 bounds), batched.

    c, A, w, gamma, sigma are (N, K); b is (N,).  λ_lo = min_i s_i'(b)/c_i,
    λ_hi = max_i s_i'(0⁺)/c_i with ε = b/(8K).  ds0 is per job, capped at
    1e30.
    """
    k = c.shape[-1]
    active = c > 0
    bk = b[..., None]

    def ds(t):
        return A * torch.clamp_min(w + sigma * t, 1e-30) ** gamma

    ds_b = ds(bk)
    eps = bk / (8.0 * k)
    ds0 = torch.where(w > 0, A * torch.clamp_min(w, 1e-300) ** gamma, _BIG)
    ds_top = torch.where(w > 0, ds0, ds(eps))
    lam_lo = torch.where(active, ds_b / c, _INF).amin(-1)
    lam_hi = torch.where(active, ds_top / c, -_INF).amax(-1) * (1.0 + 1e-6)
    lam_hi = torch.maximum(lam_hi, lam_lo * (1.0 + 1e-6))
    good = torch.isfinite(lam_lo) & (lam_lo > 0) & torch.isfinite(lam_hi)
    return (torch.where(good, lam_lo, 1.0), torch.where(good, lam_hi, 2.0),
            ds0)


def _bisect(theta_of, lam_lo, lam_hi, b, iters):
    """The kernels' 64-step log-space λ-bisection, then the exact rescale."""
    lo, hi = lam_lo, lam_hi
    for _ in range(iters):
        mid = torch.exp(0.5 * (torch.log(lo) + torch.log(hi)))
        right = theta_of(mid).sum(-1) > b        # β > b ⇒ λ* right of mid
        lo2 = torch.where(right, mid, lo)
        hi2 = torch.where(right, hi, mid)
        fixed = (lo2 == lo) & (hi2 == hi)
        lo, hi = lo2, hi2
        if stops_early(fixed):
            break
    th = theta_of(torch.exp(0.5 * (torch.log(lo) + torch.log(hi))))
    tot = th.sum(-1, keepdim=True)
    bk = b[..., None]
    th = torch.where(tot > 0, th * (bk / tot), th)
    return torch.minimum(th, bk)


def generic_waterfill_ref(c, A, w, gamma, b, sigma=1, iters=64):
    """Batched generic waterfill: (N, K) c → (N, K) θ.

    A, w, gamma, b are (N,) per-instance scalars (or broadcast to it);
    ``sigma`` (±1) is shared.  Inactive slots are marked by c = 0.
    """
    N = c.shape[0]
    A, w, gamma, b = (torch.broadcast_to(torch.as_tensor(x, dtype=c.dtype,
                                                         device=c.device),
                                         (N,))
                      for x in (A, w, gamma, b))
    lam_lo, lam_hi, ds0 = lam_bracket(c, A, w, gamma, b, sigma)
    active = c > 0
    A1, w1, g1, b1, ds01 = (x[:, None] for x in (A, w, gamma, b, ds0))

    def theta_of(lam):
        y = c * lam[:, None]
        base = torch.where(active, y / A1, 1.0)
        th = sigma * (base ** (1.0 / g1) - w1)
        th = torch.minimum(torch.clamp_min(th, 0.0), b1)
        th = torch.where(y >= ds01, 0.0, th)
        return torch.where(active, th, 0.0)

    return _bisect(theta_of, lam_lo, lam_hi, b, iters)


def hetero_waterfill_ref(c, A, w, gamma, sigma, b, iters=64):
    """Batched per-job waterfill: (N, K) job-indexed parameters.

    Every array is (N, K) except b (N,); σ entries are ±1 per job.
    Inactive slots are marked by c = 0 and carry valid family
    parameters (edge-replicated, never zeroed).
    """
    shape = c.shape
    A, w, gamma, sigma = (torch.broadcast_to(
        torch.as_tensor(x, dtype=c.dtype, device=c.device), shape)
        for x in (A, w, gamma, sigma))
    b = torch.broadcast_to(torch.as_tensor(b, dtype=c.dtype, device=c.device),
                           shape[:1])
    lam_lo, lam_hi, ds0 = hetero_lam_bracket(c, A, w, gamma, sigma, b)
    active = c > 0
    bk = b[:, None]

    def theta_of(lam):
        y = c * lam[:, None]
        base = torch.where(active, torch.clamp_min(y / A, 1e-30), 1.0)
        th = sigma * (base ** (1.0 / gamma) - w)
        th = torch.minimum(torch.clamp_min(th, 0.0), bk)
        th = torch.where(y >= ds0, 0.0, th)
        return torch.where(active, th, 0.0)

    return _bisect(theta_of, lam_lo, lam_hi, b, iters)
