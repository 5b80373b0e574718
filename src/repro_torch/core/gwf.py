"""General Water-Filling (GWF) — Algorithm 1 of the paper, in PyTorch.

Solves the *Constrained Allocation Problem* (CAP): given a concave speedup
``s``, a budget ``b`` and derivative-ratio constants ``c_1 ≥ … ≥ c_k > 0``,
find allocations ``θ`` with Σθ = b, s'(θ_j)/s'(θ_i) = c_j/c_i whenever
both are positive, and s'(θ_j)/s'(0) ≥ c_j/c_i for a parked job i.

Every solver is written batch-first: ``c`` is ``(..., k)``, the budget
``b`` broadcasts to ``c.shape[:-1]`` and every reduction runs over the
last axis, so one call solves a whole stack of instances (the JAX
package's ``vmap``).  Speedup leaves must broadcast against ``c``:
scalars are shared, ``(..., 1)`` leaves are per instance and
``(..., k)`` leaves are per job.

``solve_cap_regular``
    Closed form for a shared regular family: rectangle bottles
    θ_i(h) = u_i (h − h_i)^+, one stable sort of the bottle starts and
    prefix sums give β at every breakpoint (``waterfill_prepare``), and
    ``waterfill_solve`` inverts β(h) = b in O(k) per budget.
``solve_cap_regular_reference``
    The O(k²) breakpoint search kept as the differential oracle.
``solve_cap_generic`` / ``solve_cap_hetero``
    λ-bisection for any speedup (per-job leaves included), with a
    validated warm ``bracket``, an adaptive ``rel_tol`` exit and
    ``return_bracket``.
``hetero_prepare`` / ``hetero_solve`` / ``solve_cap_hetero_sorted``
    The sorted-breakpoint per-job solver: ``searchsorted`` brackets λ*
    inside one segment, a safeguarded Newton step in log λ polishes it.
    Per-job SmartFill keeps the breakpoints in a store it updates one
    job an iteration (``hetero_breakpoints_init``/``_insert``), runs
    warm probes with ``hetero_solve(unroll=)`` and places its μ-grid
    with the one-pass ``hetero_approx``.
``solve_cap_batched``
    The N-instance front door.  ``impl="auto"`` (``auto_impl``) sends a
    float32 CUDA call on a regular family to the hand-written float32
    CUDA waterfill kernels at every k; every other call, float64 on the
    card included, takes the closed form, the sorted solver or the
    bisection in its own dtype, as the JAX package does off the TPU.

Adaptive loops (JAX's ``while_loop``) run a fixed maximum count with a
per-row ``done`` mask that freezes the carry, so the result is JAX's and
nothing syncs to the host on the card.
"""
from __future__ import annotations

import typing

import torch

from .._device import as_tensor, resolve_device, stops_early, vpow
from .speedup import (RegularSpeedup, Speedup, StackedSpeedup, inner_per_job,
                      is_per_job, leaves, map_leaves, per_instance)

__all__ = [
    "solve_cap",
    "solve_cap_regular",
    "solve_cap_regular_reference",
    "solve_cap_generic",
    "solve_cap_hetero",
    "cap_bracket_probe",
    "solve_cap_hetero_sorted",
    "solve_cap_batched",
    "waterfill_prepare",
    "waterfill_solve",
    "waterfill_level",
    "HeteroPrep",
    "hetero_prepare",
    "hetero_breakpoints_init",
    "hetero_breakpoints_insert",
    "hetero_solve",
    "hetero_approx",
    "auto_impl",
    "cap_residual",
]

_BIG = 1e30
_INF = float("inf")


def _inputs(sp, c, active, device):
    """(sp, c, mask) on the entry point's device; c keeps its dtype."""
    dev = resolve_device(device, c, sp)
    c = as_tensor(c, dev)
    if active is None:
        active = torch.ones(c.shape, dtype=torch.bool, device=dev)
    else:
        active = as_tensor(active, dev, torch.bool)
    return map_leaves(sp, lambda l: l.to(dev)), c, active


def _scalar(b, like):
    """A budget as a tensor of ``like``'s dtype and device."""
    return as_tensor(b, like.device, like.dtype)


def waterfill_prepare(u, h0, active=None):
    """O(k log k) factorization of the WFP for fixed bottles (u, h0).

    The uncapped fill curve β(h) = Σᵢ uᵢ·(h − h0ᵢ)⁺ is piecewise linear
    with the bottle starts as breakpoints; one stable sort of the starts
    and prefix sums of uᵢ and uᵢ·h0ᵢ give β at every breakpoint.  The
    factorization does not depend on the budget.  Inactive bottles must
    arrive with u = 0.  Returns (pos, slope, vals), each (..., k).
    """
    if active is None:
        active = u > 0
    u, h0, active = torch.broadcast_tensors(u, h0, active)
    # Finite sentinel just past the largest active start: a huge constant
    # would multiply fp residue in the prefix sums and corrupt β's tail.
    h0_max = torch.where(active, h0, -_INF).amax(-1, keepdim=True)
    sentinel = torch.where(torch.isfinite(h0_max), h0_max + 1.0,
                           torch.ones_like(h0_max))
    pos = torch.where(active, h0, sentinel)
    order = torch.argsort(pos, dim=-1, stable=True)
    pos = pos.gather(-1, order)
    slope = torch.cumsum(u.gather(-1, order), -1)
    offset = torch.cumsum((u * torch.where(active, h0, 0.0)).gather(-1, order),
                          -1)
    vals = pos * slope - offset                   # β at each breakpoint
    return pos, slope, vals


def _invert_many(prep, bq):
    """Levels h with β(h) = bq for a trailing axis of budgets (..., G)."""
    pos, slope, vals = prep
    k = pos.shape[-1]
    bq = bq.expand(*vals.shape[:-1], bq.shape[-1]).contiguous()
    idx = torch.searchsorted(vals.contiguous(), bq, side="left")
    idx = idx.clamp(1, k) - 1
    seg_slope = slope.gather(-1, idx)
    p = pos.gather(-1, idx)
    pos_slope = seg_slope > 0
    h = p + (bq - vals.gather(-1, idx)) / torch.where(pos_slope, seg_slope,
                                                      1.0)
    return torch.where(pos_slope, h, p)


def _invert_fill_curve(prep, b):
    """Level h with β(h) = b on a prepared curve — O(k) per budget.

    Beyond the last breakpoint β is linear with the total slope, so the
    same interpolation extrapolates; on a zero-slope segment the
    segment's left edge is returned.
    """
    b = _scalar(b, prep[0])
    return _invert_many(prep, b[..., None])[..., 0]


def waterfill_solve(prep, u, h0, b, active):
    """θᵢ = clip(uᵢ·(h* − h0ᵢ), 0, b) with β(h*) = b — O(k) per budget."""
    b = _scalar(b, prep[0])
    h = _invert_fill_curve(prep, b)[..., None]
    bk = b[..., None]
    theta = torch.minimum(torch.clamp_min(u * (h - h0), 0.0), bk)
    return torch.where(active & (bk > 0), theta, 0.0)


def waterfill_solve_many(prep, u, h0, bq, active):
    """``waterfill_solve`` at a trailing axis of budgets: bq (..., G) →
    θ (..., G, k).  SmartFill prices its μ-grid with one call."""
    h = _invert_many(prep, bq)[..., None]
    bk = bq[..., None]
    theta = torch.minimum(
        torch.clamp_min(u[..., None, :] * (h - h0[..., None, :]), 0.0), bk)
    return torch.where(active[..., None, :] & (bk > 0), theta, 0.0)


def waterfill_level(u, h0, b, active=None):
    """Exact water level h with β(h) = b, in O(k log k) (one-shot)."""
    if active is None:
        active = u > 0
    return _invert_fill_curve(waterfill_prepare(u, h0, active), b)


def solve_cap_regular(sp: RegularSpeedup, b, c, active=None, device=None):
    """Closed-form CAP for regular speedup functions — O(k log k).

    Args:
      sp: RegularSpeedup with ``s'(θ) = A (w + σθ)^γ``.
      b: budget, ``0 ≤ b ≤ B``; scalar or one per instance.
      c: (..., k) derivative-ratio constants, non-increasing.
      active: optional (..., k) mask; inactive jobs get θ = 0.

    Returns (..., k) allocations θ with Σθ = b.
    """
    sp, c, active = _inputs(sp, c, active, device)
    b = _scalar(b, c)
    b_safe = torch.clamp_min(b, 1e-300)
    u = torch.where(active, sp.bottle_width(c), 0.0)
    h0 = sp.bottle_bottom(c)
    theta = waterfill_solve(waterfill_prepare(u, h0, active), u, h0, b_safe,
                            active)
    return torch.where(b[..., None] > 0, theta, 0.0)


def solve_cap_regular_reference(sp: RegularSpeedup, b, c, active=None,
                                device=None):
    """O(k²) closed-form CAP (β re-evaluated at every breakpoint).

    The differential-test oracle for ``solve_cap_regular``.
    """
    sp, c, active = _inputs(sp, c, active, device)
    k = c.shape[-1]
    b = _scalar(b, c)
    b_safe = torch.clamp_min(b, 1e-300)
    bk = b_safe[..., None]
    u = sp.bottle_width(c)
    h0 = sp.bottle_bottom(c)
    u, h0, active = torch.broadcast_tensors(torch.where(active, u, 0.0), h0,
                                            active)
    starts = torch.where(active, h0, _BIG)
    caps = torch.where(active, h0 + bk / torch.clamp_min(u, 1e-300),
                       2.0 * _BIG)
    bp = torch.sort(torch.cat([starts, caps], -1), -1).values   # (..., 2k)
    vol = torch.minimum(torch.clamp_min(
        u[..., None, :] * (bp[..., :, None] - h0[..., None, :]), 0.0),
        bk[..., None])
    vals = torch.where(active[..., None, :], vol, 0.0).sum(-1)   # (..., 2k)
    bq = bk.expand(*vals.shape[:-1], 1).contiguous()
    idx = torch.searchsorted(vals.contiguous(), bq, side="left")
    idx = idx.clamp(1, 2 * k - 1)
    h_lo = bp.gather(-1, idx - 1)
    h_hi = bp.gather(-1, idx)
    v_lo = vals.gather(-1, idx - 1)
    in_seg = active & (h_lo >= starts - 1e-300) & (h_lo < caps)
    slope = torch.where(in_seg, u, 0.0).sum(-1, keepdim=True)
    h_interp = h_lo + (bk - v_lo) / torch.where(slope > 0, slope, 1.0)
    h = torch.where(slope > 0, torch.minimum(h_interp, h_hi), h_lo)
    theta = torch.minimum(torch.clamp_min(u * (h - h0), 0.0), bk)
    theta = torch.where(active, theta, 0.0)
    return torch.where(b[..., None] > 0, theta, 0.0)


def _lam_mid(lo, hi):
    """Log-space midpoint: relative precision across wide λ ranges."""
    return torch.exp(0.5 * (torch.log(lo) + torch.log(hi)))


def _ds0(sp, c):
    """s_i'(0) broadcast to c's shape, in c's dtype and on its device."""
    d = sp.ds0() if leaves(sp) else sp.ds(
        torch.zeros((), dtype=c.dtype, device=c.device))
    return torch.broadcast_to(d.to(c.dtype), c.shape)


def _generic_setup(sp, b, c, active):
    """(b_safe, θ(λ), ds0) of the generic λ-bisection for one stack."""
    k = c.shape[-1]
    b = _scalar(b, c)
    b_safe = torch.clamp_min(b, 1e-300)
    bk = b_safe[..., None]
    ds0 = _ds0(sp, c)

    def theta_of(lam):
        y = c * lam[..., None]
        th = torch.minimum(torch.clamp_min(sp.ds_inv(y), 0.0), bk)
        # park jobs whose marginal value at zero is already below the level
        th = torch.where(y >= ds0, 0.0, th)
        return torch.where(active, th, 0.0)

    return b, b_safe, theta_of, ds0, k


def solve_cap_generic(sp: Speedup, b, c, active=None, iters: int = 96,
                      bracket=None, rel_tol: float | None = None,
                      return_bracket: bool = False, device=None):
    """CAP for arbitrary concave speedups — bisection on water pressure λ.

    θ_i(λ) = clip(s_i'⁻¹(c_i λ), 0, b); β(λ) = Σ θ_i(λ) is strictly
    decreasing, so a scalar bisection (in log λ) finds β(λ) = b.  The safe
    bracket is [min_i s_i'(b)/c_i, max_i s_i'(0⁺)/c_i]; an infinite s'(0)
    is replaced by s'(ε) with ε = b/(8k).

    Args:
      bracket: optional (λ_lo, λ_hi) warm start, one per instance.  Each
        end is validated against β before use, so a stale hint costs two
        β evaluations but never a wrong answer.
      rel_tol: when set, a row stops once ``hi ≤ lo·(1 + rel_tol)``
        (floored at 16 ulp of the dtype), within ``iters`` steps.
      return_bracket: also return the final (λ_lo, λ_hi).
    """
    sp, c, active = _inputs(sp, c, active, device)
    b, b_safe, theta_of, ds0, k = _generic_setup(sp, b, c, active)
    bk = b_safe[..., None]
    ds_b = torch.broadcast_to(sp.ds(bk), c.shape)
    eps = bk / (8.0 * k)
    ds_top = torch.where(torch.isfinite(ds0), ds0,
                         torch.broadcast_to(sp.ds(eps), c.shape))

    lam_lo = torch.where(active, ds_b / c, _INF).amin(-1)       # β(lo) ≥ b
    lam_hi = torch.where(active, ds_top / c, -_INF).amax(-1) * (1.0 + 1e-9)
    lam_hi = torch.maximum(lam_hi, lam_lo * (1.0 + 1e-9))

    if bracket is not None:
        w_lo = torch.clamp_min(_scalar(bracket[0], c), 1e-300)
        w_hi = _scalar(bracket[1], c)
        # β decreasing: β(w_lo) ≥ b ⇔ λ* ≥ w_lo; β(w_hi) ≤ b ⇔ λ* ≤ w_hi
        lam_lo = torch.where(theta_of(w_lo).sum(-1) >= b_safe,
                             torch.maximum(w_lo, lam_lo), lam_lo)
        lam_hi = torch.where(theta_of(w_hi).sum(-1) <= b_safe,
                             torch.minimum(w_hi, lam_hi), lam_hi)
        lam_hi = torch.maximum(lam_hi, lam_lo * (1.0 + 1e-12))

    lo, hi = lam_lo, lam_hi
    if rel_tol is not None:
        rel = max(float(rel_tol), 16.0 * torch.finfo(c.dtype).eps)
    for _ in range(iters):
        if rel_tol is None:
            run = torch.ones_like(lo, dtype=torch.bool)
        else:
            run = hi > lo * (1.0 + rel)
        mid = _lam_mid(lo, hi)
        right = theta_of(mid).sum(-1) > b_safe    # β > b ⇒ λ* right of mid
        lo2 = torch.where(run & right, mid, lo)
        hi2 = torch.where(run & ~right, mid, hi)
        fixed = (lo2 == lo) & (hi2 == hi)
        lo, hi = lo2, hi2
        if stops_early(fixed):
            break

    theta = theta_of(_lam_mid(lo, hi))
    # exact budget: rescale the fp residual onto the positive allocations
    tot = theta.sum(-1, keepdim=True)
    theta = torch.where(tot > 0, theta * (bk / tot), theta)
    theta = torch.minimum(theta, bk)
    theta = torch.where(b[..., None] > 0, theta, 0.0)
    if return_bracket:
        return theta, (lo, hi)
    return theta


def cap_bracket_probe(sp: Speedup, b, c, bracket, active=None, device=None):
    """β-probe a carried λ-bracket against the live CAP instance.

    Returns ``(lo_ok, hi_ok)``: the lower end is valid iff β(lo) ≥ b and
    the upper iff β(hi) ≤ b.  Two O(k) β evaluations.
    """
    sp, c, active = _inputs(sp, c, active, device)
    _, b_safe, theta_of, _, _ = _generic_setup(sp, b, c, active)
    lo = torch.clamp_min(_scalar(bracket[0], c), 1e-300)
    hi = _scalar(bracket[1], c)
    return theta_of(lo).sum(-1) >= b_safe, theta_of(hi).sum(-1) <= b_safe


def solve_cap_hetero(sp: Speedup, b, c, active=None, iters: int = 96,
                     **kwargs):
    """CAP with per-job speedup functions (paper §7) — O(M) per probe.

    ``solve_cap_generic``, which is per-job aware throughout, under its
    §7 name.
    """
    return solve_cap_generic(sp, b, c, active, iters=iters, **kwargs)


class HeteroPrep(typing.NamedTuple):
    """Budget-independent factorization of the per-job CAP (paper §7).

    For regular-family jobs the uncapped allocation is closed form in λ:
    θ̃_i(λ) = max(P_i λ^{E_i} − Q_i, 0) with P_i = σ_i (c_i/A_i)^{E_i},
    E_i = 1/γ_i, Q_i = σ_i w_i; job i parks at λ_act_i = s_i'(0)/c_i.
    ``pos`` holds the breakpoints sorted descending and ``vals`` the
    curve β̃ there (ascending).  All fields are (..., M).
    """

    P: torch.Tensor
    E: torch.Tensor
    Q: torch.Tensor
    A: torch.Tensor
    w: torch.Tensor
    gamma: torch.Tensor
    sigma: torch.Tensor
    c: torch.Tensor
    act: torch.Tensor
    pos: torch.Tensor
    vals: torch.Tensor


def _hetero_leaves(sp: Speedup, c):
    """The regular-family leaves (A, w, γ, σ) broadcast to c's shape."""
    if not isinstance(sp, (RegularSpeedup, StackedSpeedup)):
        raise ValueError(
            "sorted-bracket hetero CAP needs a (possibly per-job) "
            "regular-family speedup (RegularSpeedup or StackedSpeedup)")
    sigma = sp.sigma if isinstance(sp.sigma, torch.Tensor) else (
        torch.full((), float(sp.sigma), dtype=c.dtype, device=c.device))
    return tuple(torch.broadcast_to(l.to(c.dtype), c.shape)
                 for l in (sp.A, sp.w, sp.gamma, sigma))


def _hetero_coeffs(A, w, gamma, sigma, c, act):
    """(P, E, Q) of the uncapped curve plus λ_act per job (0 inactive)."""
    c_safe = torch.where(act, c, 1.0)
    E = 1.0 / gamma
    P = sigma * vpow(c_safe / A, E)
    Q = sigma * w
    ds0 = torch.where(w > 0, A * vpow(torch.clamp_min(w, 1e-300), gamma),
                      _INF)
    lam_act = torch.where(act, ds0 / c_safe, 0.0)
    return P, E, Q, lam_act


def _beta_tilde(P, E, Q, act, lam):
    """Uncapped fill curve β̃(λ) = Σ_act max(P λ^E − Q, 0); lam (...)."""
    term = P * vpow(lam[..., None], E) - Q
    return torch.where(act, torch.clamp_min(term, 0.0), 0.0).sum(-1)


def hetero_breakpoints_init(M: int, dtype=torch.float64, device=None,
                            batch: tuple = ()):
    """Empty per-job breakpoint store: λ = 0, β̃-value = +∞ sentinels.

    Two ``batch + (M,)`` tensors; slot i belongs to job i (unsorted).
    ``hetero_breakpoints_insert`` activates one job at a time in O(M),
    which lets SmartFill keep the exact sorted-breakpoint curve across
    its iterations instead of re-evaluating the O(M²) breakpoint matrix:
    the constants c of already-active jobs never change, one c_k arrives
    per iteration.
    """
    dev = resolve_device(device)
    shape = tuple(batch) + (M,)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.full(shape, _INF, dtype=dtype, device=dev))


def hetero_breakpoints_insert(sp: Speedup, c, k: int, bp_lam, bp_val,
                              live=True):
    """Activate job ``k`` (with its ratio constant ``c[..., k]``) in O(M).

    Adds job k's uncapped term max(P_k λ^{E_k} − Q_k, 0) to the stored
    β̃ value of every existing breakpoint and evaluates the current curve
    once at job k's own breakpoint λ_act_k.  ``live`` (a bool or one per
    instance) masks the insert, so padded iterations leave the store as
    it was.
    """
    M = c.shape[-1]
    idx = torch.arange(M, device=c.device)
    prev = (idx < k).expand(c.shape)            # jobs already in the store
    A, w, gamma, sigma = _hetero_leaves(sp, c)
    P, E, Q, _ = _hetero_coeffs(A, w, gamma, sigma, c, prev)

    c_k = torch.clamp_min(c[..., k], 1e-300)
    E_k, A_k, w_k, s_k = E[..., k], A[..., k], w[..., k], sigma[..., k]
    P_k = s_k * vpow(c_k / A_k, E_k)
    Q_k = s_k * w_k
    ds0_k = torch.where(w_k > 0, A_k * vpow(torch.clamp_min(w_k, 1e-300),
                                            gamma[..., k]), _INF)
    lam_k = ds0_k / c_k

    g = torch.clamp_min(P_k[..., None] * vpow(bp_lam, E_k[..., None])
                        - Q_k[..., None], 0.0)
    val_k = _beta_tilde(P, E, Q, prev, lam_k)
    here = idx == k
    bp_lam2 = torch.where(here, lam_k[..., None], bp_lam)
    bp_val2 = torch.where(here, val_k[..., None], bp_val + g)
    live = as_tensor(live, c.device, torch.bool)[..., None]
    return (torch.where(live, bp_lam2, bp_lam),
            torch.where(live, bp_val2, bp_val))


def _hetero_prepare(sp, c, active, breakpoints=None):
    A, w, gamma, sigma = _hetero_leaves(sp, c)
    P, E, Q, lam_act = _hetero_coeffs(A, w, gamma, sigma, c, active)
    if breakpoints is None:
        term = (P[..., None, :] * vpow(lam_act[..., :, None], E[..., None, :])
                - Q[..., None, :])                      # (..., λ, job)
        curve = torch.where(active[..., None, :], torch.clamp_min(term, 0.0),
                            0.0).sum(-1)
        bp_lam, bp_val = lam_act, torch.where(active, curve, _INF)
    else:
        bp_lam, bp_val = breakpoints
    order = torch.argsort(-bp_lam, dim=-1, stable=True)
    return HeteroPrep(P=P, E=E, Q=Q, A=A, w=w, gamma=gamma, sigma=sigma,
                      c=c, act=active, pos=bp_lam.gather(-1, order),
                      vals=bp_val.gather(-1, order))


def hetero_prepare(sp: Speedup, c, active=None, breakpoints=None,
                   device=None):
    """Factorize the per-job CAP: sort the activation breakpoints once.

    Everything budget-independent — the term coefficients (P, E, Q), the
    breakpoints λ_act_i and the uncapped curve values β̃(λ_act_j) — is
    computed here, so ``hetero_solve`` prices any number of budgets
    against one sort.  Without ``breakpoints`` the curve values are
    evaluated directly (an O(M²) pass); per-job SmartFill passes the
    ``(bp_lam, bp_val)`` store it keeps with ``hetero_breakpoints_insert``
    instead, which keeps an iteration at O(M log M).
    """
    sp, c, active = _inputs(sp, c, active, device)
    return _hetero_prepare(sp, c, active, breakpoints)


def _safe_lam_bounds(prep, b_lo, b_hi):
    """Safe λ bracket of ``solve_cap_generic`` from the prepared leaves:
    λ_lo = min_i s_i'(b_hi)/c_i, λ_hi = max_i s_i'(0⁺)/c_i with s_i'(ε),
    ε = b_lo/(8M), for an infinite s_i'(0).  b_lo, b_hi (..., 1)."""
    act, c = prep.act, prep.c
    M = c.shape[-1]
    c_safe = torch.where(act, c, 1.0)
    ds_b = prep.A * vpow(torch.clamp_min(prep.w + prep.sigma * b_hi,
                                         1e-300), prep.gamma)
    eps = b_lo / (8.0 * M)
    ds0 = torch.where(prep.w > 0,
                      prep.A * vpow(torch.clamp_min(prep.w, 1e-300),
                                    prep.gamma),
                      _INF)
    ds_top = torch.where(prep.w > 0, ds0, prep.A * vpow(eps, prep.gamma))
    lam_lo_s = torch.where(act, ds_b / c_safe, _INF).amin(-1)
    lam_hi_s = torch.where(act, ds_top / c_safe, -_INF).amax(-1) * (1 + 1e-9)
    good = (torch.isfinite(lam_lo_s) & (lam_lo_s > 0)
            & torch.isfinite(lam_hi_s) & (lam_hi_s > 0))
    lam_lo_s = torch.where(good, lam_lo_s, 1.0)
    lam_hi_s = torch.where(good, lam_hi_s, 2.0)
    return lam_lo_s, torch.maximum(lam_hi_s, lam_lo_s * (1 + 1e-9))


def hetero_solve(prep: HeteroPrep, b, iters: int = 48, lam_hint=None,
                 return_lam: bool = False, rtol: float = 1e-13,
                 unroll: int = 0):
    """Invert the prepared per-job fill curve at budget ``b``.

    ``searchsorted`` brackets λ* inside one breakpoint segment; the
    bracket is intersected with the safe bounds of ``solve_cap_generic``
    and both ends are validated with a β̃ evaluation.  A safeguarded
    Newton iteration in t = log λ (Illinois false position and then the
    midpoint as fallbacks) converges from a log-secant start, or from
    ``lam_hint``, and each row stops once its step is a few ulp or its
    budget residual is within ``rtol``·b, or once Newton proposes a step
    of a few ulp at a residual under 1e-3·b (the JAX package lacks this
    exit and can leave such a solve unconverged).

    ``unroll`` > 0 runs exactly that many steps instead, on every row
    (no exit), and trusts the stored segment-end values for the false
    position's residuals instead of re-evaluating β̃ at the ends: the
    warm probes of per-job SmartFill, where a neighbouring λ* reaches
    float64 precision in a few steps.
    """
    P, E, Q, act, c = prep.P, prep.E, prep.Q, prep.act, prep.c
    dt = c.dtype
    M = c.shape[-1]
    b = _scalar(b, c).expand(c.shape[:-1])
    b_safe = torch.clamp_min(b, 1e-300)
    bk = b_safe[..., None]
    lam_lo_s, lam_hi_s = _safe_lam_bounds(prep, bk, bk)

    # segment bracket: vals[idx−1] ≤ b ≤ vals[idx] ⇒ λ* ∈ [pos[idx],
    # pos[idx−1]] (pos descending, β̃ decreasing)
    idx = torch.searchsorted(prep.vals.contiguous(), bk.contiguous(),
                             side="left").clamp(1, M - 1)
    lo = torch.maximum(prep.pos.gather(-1, idx)[..., 0], lam_lo_s)
    hi = torch.minimum(prep.pos.gather(-1, (idx - 1) % M)[..., 0], lam_hi_s)
    bad = ~(hi > lo)
    lo = torch.where(bad, lam_lo_s, lo)
    hi = torch.where(bad, lam_hi_s, hi)
    if unroll > 0:
        # a degenerate segment marks the residuals non-finite, which
        # turns the false position off (the midpoint takes over)
        v_lo = prep.vals.gather(-1, idx)[..., 0]
        v_hi = prep.vals.gather(-1, (idx - 1) % M)[..., 0]
        okf = ~bad & torch.isfinite(v_lo) & torch.isfinite(v_hi)
        flo = torch.where(okf, v_lo - b_safe, _INF)
        fhi = torch.where(okf, v_hi - b_safe, -_INF)
        hi = torch.maximum(hi, lo * (1 + 1e-12))
    else:
        lo = torch.where(_beta_tilde(P, E, Q, act, lo) >= b_safe, lo,
                         lam_lo_s)
        hi = torch.where(_beta_tilde(P, E, Q, act, hi) <= b_safe, hi,
                         lam_hi_s)
        hi = torch.maximum(hi, lo * (1 + 1e-12))
        # residuals at the ends actually used (false position steers by
        # them)
        flo = _beta_tilde(P, E, Q, act, lo) - b_safe
        fhi = _beta_tilde(P, E, Q, act, hi) - b_safe

    tlo = torch.log(lo)
    thi = torch.log(hi)
    # log-secant start in (t, log β̃); plain secant, then the midpoint,
    # when an end has β̃ = 0
    blo_v = flo + b_safe
    bhi_v = fhi + b_safe
    lg_b = torch.log(b_safe)
    l_blo = torch.log(torch.clamp_min(blo_v, 1e-300))
    den_l = l_blo - torch.log(torch.clamp_min(bhi_v, 1e-300))
    frac_l = (l_blo - lg_b) / torch.where(den_l > 0, den_l, 1.0)
    den0 = flo - fhi
    frac = torch.where((bhi_v > 0) & (den_l > 0), frac_l,
                       torch.where(den0 > 0,
                                   flo / torch.where(den0 > 0, den0, 1.0),
                                   0.5))
    t_sec = tlo + frac * (thi - tlo)
    t = torch.where(torch.isfinite(t_sec),
                    torch.minimum(torch.maximum(t_sec, tlo), thi),
                    0.5 * (tlo + thi))
    if lam_hint is not None:
        lam_hint = _scalar(lam_hint, c)
        use = torch.isfinite(lam_hint) & (lam_hint > lo) & (lam_hint < hi)
        t = torch.where(use, torch.log(torch.clamp_min(lam_hint, 1e-300)), t)

    tol = 4.0 * torch.finfo(dt).eps
    rtol_b = rtol * b_safe

    def step_(t, tlo, thi, flo, fhi, prev_up, first):
        u = P * torch.exp(E * t[..., None])
        th = u - Q
        on = act & (th > 0)
        beta = torch.where(on, th, 0.0).sum(-1)
        phi = beta - b_safe
        dphi = torch.where(on, u * E, 0.0).sum(-1)       # dβ̃/dt < 0
        # Newton on log β̃(t), exact for a one-family segment
        tn = t - torch.log(torch.clamp_min(beta, 1e-300) / b_safe) * beta / dphi
        # a Newton step below the step tolerance at a residual already
        # small against b is convergence too: where β̃ is a small
        # difference of large terms (a saturating job with w ≫ b) its
        # rounding exceeds rtol·b, so the residual exit never fires, and
        # the proposal t itself is a bracket end that the strict tests
        # below reject: the fallback would fling t back into the segment
        # (at b ≤ 0 the clamped log makes every step 0, hence the
        # residual's guard)
        done = (torch.abs(phi) <= rtol_b) | (
            (torch.abs(tn - t) <= tol) & (torch.abs(phi) <= 1e-3 * b_safe))
        up = phi > 0                                      # λ* above t
        tlo2 = torch.where(up, t, tlo)
        flo2 = torch.where(up, phi, flo)
        thi2 = torch.where(up, thi, t)
        fhi2 = torch.where(up, fhi, phi)
        if not first:
            # Illinois: halve the stale end's residual when one end moves
            # twice running
            fhi2 = torch.where(up & prev_up, 0.5 * fhi2, fhi2)
            flo2 = torch.where(~(up | prev_up), 0.5 * flo2, flo2)
        den = flo2 - fhi2
        den_ok = den > 0
        tf = tlo2 + (flo2 / torch.where(den_ok, den, 1.0)) * (thi2 - tlo2)
        # the bracket ends are finite, so the comparisons also reject a
        # step that is not
        use_n = (beta > 0) & (tn > tlo2) & (tn < thi2)
        use_f = den_ok & (tf > tlo2) & (tf < thi2)
        t2 = torch.where(use_n, tn,
                         torch.where(use_f, tf, 0.5 * (tlo2 + thi2)))
        return torch.where(done, t, t2), tlo2, thi2, flo2, fhi2, up, done

    prev_up = torch.zeros_like(t, dtype=torch.bool)
    if unroll > 0:
        for i in range(unroll):
            t, tlo, thi, flo, fhi, prev_up, _ = step_(
                t, tlo, thi, flo, fhi, prev_up, i == 0)
    else:
        # a non-positive budget has the trivial answer θ = 0: start
        # converged
        step = torch.where(b > 0, _INF, 0.0).to(dt)
        for i in range(iters):
            run = step > tol
            t2, *rest, done = step_(t, tlo, thi, flo, fhi, prev_up, i == 0)
            step2 = torch.where(done, 0.0, torch.abs(t2 - t))
            t, tlo, thi, flo, fhi, prev_up, step = (
                torch.where(run, n, o) for n, o in zip(
                    (t2, *rest, step2), (t, tlo, thi, flo, fhi, prev_up,
                                         step)))
            if stops_early(~(step > tol)):
                break

    lam = torch.exp(t)
    theta = torch.where(act, P * torch.exp(E * t[..., None]) - Q, 0.0)
    theta = torch.minimum(torch.clamp_min(theta, 0.0), bk)
    tot = theta.sum(-1, keepdim=True)
    theta = torch.where(tot > 0, theta * (bk / tot), theta)
    theta = torch.minimum(theta, bk)
    theta = torch.where(b[..., None] > 0, theta, 0.0)
    if return_lam:
        return theta, lam
    return theta


def hetero_approx(prep: HeteroPrep, b):
    """One fused pass of the prepared fill curve — no Newton iteration.

    ``searchsorted`` picks the breakpoint segment and a log-secant
    through the stored segment-end values places λ̂ — exact when the
    segment's active set is one regular family, a few per cent off
    otherwise.  The clipped allocation at λ̂ is rescaled onto the budget,
    so the result is always feasible (Σθ̂ = b).

    ``b`` is one budget per instance (shape ``prep.c.shape[:-1]`` or
    less) or a trailing axis of G budgets per instance (``(..., G)``,
    one more axis than that), which prices a whole μ-grid in two fused
    (..., G, M) passes; the safe λ bounds are then taken once per
    instance at its largest and smallest budget.  The localization probe
    of per-job SmartFill's μ* minimizer, never an answer itself.
    """
    P, E, Q, act, c = prep.P, prep.E, prep.Q, prep.act, prep.c
    M = c.shape[-1]
    b = _scalar(b, c)
    grid = b.ndim == c.ndim
    bv = b if grid else b[..., None]
    bv = bv.expand(*c.shape[:-1], bv.shape[-1])
    b_safe = torch.clamp_min(bv, 1e-300)                      # (..., G)
    lam_lo_s, lam_hi_s = _safe_lam_bounds(
        prep, b_safe.amin(-1, keepdim=True), b_safe.amax(-1, keepdim=True))
    lam_lo_s, lam_hi_s = lam_lo_s[..., None], lam_hi_s[..., None]

    idx = torch.searchsorted(prep.vals.contiguous(), b_safe.contiguous(),
                             side="left").clamp(1, M - 1)     # (..., G)
    up = (idx - 1) % M
    lo = torch.minimum(torch.maximum(prep.pos.gather(-1, idx), lam_lo_s),
                       lam_hi_s)
    hi = torch.minimum(torch.maximum(prep.pos.gather(-1, up), lam_lo_s),
                       lam_hi_s)
    hi = torch.maximum(hi, lo * (1 + 1e-12))
    vlo = prep.vals.gather(-1, idx)     # β̃ at the segment's low-λ end (≥ b)
    vhi = prep.vals.gather(-1, up)      # β̃ at the high-λ end (≤ b)
    ok = (torch.isfinite(vlo) & torch.isfinite(vhi) & (vlo > 0) & (vhi > 0)
          & (vlo > vhi))
    l_vlo = torch.log(torch.clamp_min(vlo, 1e-300))
    num = l_vlo - torch.log(b_safe)
    den = l_vlo - torch.log(torch.clamp_min(vhi, 1e-300))
    frac = torch.where(ok, num / torch.where(den > 0, den, 1.0), 0.5)
    t = torch.log(lo) + torch.clamp(frac, 0.0, 1.0) * (torch.log(hi)
                                                        - torch.log(lo))

    bq = b_safe[..., None]
    theta = torch.where(act[..., None, :],
                        P[..., None, :] * torch.exp(E[..., None, :]
                                                    * t[..., None])
                        - Q[..., None, :], 0.0)               # (..., G, M)
    theta = torch.minimum(torch.clamp_min(theta, 0.0), bq)
    tot = theta.sum(-1, keepdim=True)
    theta = torch.where(tot > 0, theta * (bq / tot), theta)
    theta = torch.minimum(theta, bq)
    theta = torch.where(bv[..., None] > 0, theta, 0.0)
    return theta if grid else theta[..., 0, :]


def solve_cap_hetero_sorted(sp: Speedup, b, c, active=None, iters: int = 48,
                            return_lam: bool = False, device=None):
    """One-shot sorted-bracket per-job CAP (prepare + solve).

    The fast §7 path for regular-family per-job speedups; non-regular
    speedups use ``solve_cap_hetero``/``solve_cap_generic``.
    """
    sp, c, active = _inputs(sp, c, active, device)
    prep = hetero_prepare(sp, c, active)
    return hetero_solve(prep, b, iters=iters, return_lam=return_lam)


def solve_cap(sp: Speedup, b, c, active=None, iters: int = 96, device=None):
    """Closed form for a shared RegularSpeedup; λ-bisection otherwise."""
    if isinstance(sp, RegularSpeedup) and not is_per_job(sp):
        return solve_cap_regular(sp, b, c, active, device=device)
    return solve_cap_generic(sp, b, c, active, iters=iters, device=device)


def auto_impl(device_type: str, dtype: torch.dtype, family: str) -> str:
    """The solver ``impl="auto"`` picks for a batched CAP.

    ``family`` is "regular" (one RegularSpeedup shared by the jobs),
    "per_job" (per-job regular families), "stacked" (a StackedSpeedup
    shared by the jobs) or "other".  Only a float32 CUDA input of a
    regular family goes to the CUDA kernels, which compute in float32;
    every other input keeps its dtype and takes what the JAX package's
    auto gives it off the TPU: the closed form for "regular", the sorted
    solver for "per_job", the λ-bisection otherwise.
    """
    if (device_type == "cuda" and dtype == torch.float32
            and family != "other"):
        return "cuda"
    return {"regular": "closed", "per_job": "sorted"}.get(family, "bisect")


def solve_cap_batched(sp: Speedup, b, c, active=None, iters: int = 64,
                      impl: str = "auto", device=None):
    """CAP over N instances at once: (N, k) c-vectors, scalar or (N,) b.

    The batched front door for controllers that water-fill many tenants
    per tick.  ``impl="auto"`` follows ``auto_impl``:

      * a float32 CUDA tensor with a shared RegularSpeedup runs the
        ``generic_waterfill`` CUDA kernel, and with a per-job regular
        family (job-indexed RegularSpeedup leaves or a StackedSpeedup)
        the ``hetero_waterfill`` kernel, at every k;
      * any other dtype or device (float64 on the card too) takes the
        closed form for a shared RegularSpeedup, the sorted-bracket
        solver for a per-job regular family and the λ-bisection
        otherwise, and returns θ in c's dtype.

    ``impl`` ∈ {"auto", "closed", "sorted", "bisect", "cuda"} forces a
    path ("cuda" picks the hetero kernel when ``sp`` is per-job and runs
    the kernel's plain version on a CPU tensor).  Leaves with a leading
    N are per instance; ``(N, k)`` leaves are per instance and per job.
    """
    sp, c, active = _inputs(sp, c, active, device)
    if c.ndim != 2:
        raise ValueError("c must be (N, k)")
    N, k = c.shape
    b_v = _scalar(b, c).expand(N)
    from .batch import check_axes_unambiguous

    # With N == k a 1-D leaf is per-instance or per-job with no way to
    # tell — every impl path refuses.
    check_axes_unambiguous(sp, N, k, "sp")
    per_job = inner_per_job(sp, N)
    regular = isinstance(sp, RegularSpeedup) and not per_job
    stackable = isinstance(sp, (RegularSpeedup, StackedSpeedup))
    if impl == "auto":
        family = ("regular" if regular else "per_job" if stackable and per_job
                  else "stacked" if stackable else "other")
        impl = auto_impl(c.device.type, c.dtype, family)
    if impl == "cuda":
        if not stackable:
            raise ValueError("impl='cuda' needs a (possibly per-job) "
                             "regular-family speedup")
        from ..kernels.gwf_waterfill.ops import (generic_waterfill_op,
                                                 hetero_waterfill_op)
        cm = torch.where(active, c, 0.0)
        if per_job:
            def bc(l):
                # (N,) per-instance leaves broadcast down the job axis;
                # (k,) shared-per-job leaves down the instance axis
                l = _scalar(l, c)
                if l.ndim == 1 and l.shape[0] == N:
                    l = l[:, None]
                return torch.broadcast_to(l, (N, k)).contiguous()

            sigma = (sp.sigma if isinstance(sp, StackedSpeedup)
                     else float(sp.sigma))
            return hetero_waterfill_op(cm, bc(sp.A), bc(sp.w), bc(sp.gamma),
                                       bc(sigma), b_v, iters=iters,
                                       impl="cuda")
        return generic_waterfill_op(
            cm, sp.A.to(c.dtype).expand(N), sp.w.to(c.dtype).expand(N),
            sp.gamma.to(c.dtype).expand(N), b_v, sigma=sp.sigma,
            iters=iters, impl="cuda")
    spv = per_instance(sp, N)
    if impl == "closed":
        if not regular:
            raise ValueError("impl='closed' needs a RegularSpeedup")
        return solve_cap_regular(spv, b_v, c, active)
    if impl == "sorted":
        if not stackable:
            raise ValueError("impl='sorted' needs a (possibly per-job) "
                             "regular-family speedup")
        return solve_cap_hetero_sorted(spv, b_v, c, active)
    if impl != "bisect":
        raise ValueError(f"unknown impl {impl!r}")
    return solve_cap_generic(spv, b_v, c, active, iters=iters)


def cap_residual(sp: Speedup, b, c, theta, active=None, tol: float = 1e-6,
                 device=None):
    """Max violation of the CAP constraints (9a)–(9d) by one instance's θ.

    Returns a dict of violation magnitudes (0-dim tensors); ≤ tol
    everywhere ⟺ θ solves the CAP.
    """
    sp, c, active = _inputs(sp, c, active, device)
    theta = as_tensor(theta, c.device, c.dtype)
    k = c.shape[0]
    thm = torch.where(active, theta, 0.0)
    budget = torch.abs(thm.sum() - _scalar(b, c))
    # (9b) ordering among active jobs — a shared-speedup property only
    if is_per_job(sp):
        order = torch.zeros((), dtype=c.dtype, device=c.device)
    else:
        order = torch.where(active[:-1] & active[1:], thm[:-1] - thm[1:],
                            -_INF).amax() if k > 1 else (
            torch.zeros((), dtype=c.dtype, device=c.device))
        order = torch.clamp_min(order, 0.0)
    iu = torch.arange(k, device=c.device)
    upper = iu[:, None] < iu[None, :]
    ds = sp.ds(thm)
    ds0 = _ds0(sp, c)
    pos = active & (thm > tol)
    num = ds[None, :] * c[:, None] - ds[:, None] * c[None, :]
    scale = torch.clamp_min(ds[None, :] * c[:, None], 1e-30)
    ratio_viol = torch.where(upper & pos[:, None] & pos[None, :],
                             torch.abs(num) / scale, 0.0)
    zero = active & (thm <= tol)
    ineq = (c[None, :] / c[:, None]) - (ds[None, :] / ds0[:, None])
    ineq_viol = torch.where(upper & zero[:, None] & pos[None, :]
                            & torch.isfinite(ds0)[:, None],
                            torch.clamp_min(ineq, 0.0), 0.0)
    return {"budget": budget, "order": order, "ratio": ratio_viol.amax(),
            "park": ineq_viol.amax()}
