"""Speedup-function abstractions for SmartFill scheduling (PyTorch).

The paper assumes a speedup function ``s(θ)`` on ``[0, B]`` with
``s(0) = 0``, strictly increasing, differentiable and strictly concave.

``RegularSpeedup``
    The paper's *regular* class (Definition 1), parameterized as
    ``s'(θ) = A · (w + σ θ)^γ`` with ``A > 0``, ``σ ∈ {+1, −1}``,
    ``w + σθ > 0`` on ``[0, B]`` and ``σ·γ < 0``.  Every row of the
    paper's Table 1 is one of these:

      power          s = a θ^p            (A=ap,  w=0,   σ=+1, γ=p−1)
      shifted power  s = a(θ+z)^p − a z^p (A=ap,  w=z,   σ=+1, γ=p−1)
      logarithmic    s = a ln(pθ+1)       (A=a,   w=1/p, σ=+1, γ=−1)
      neg. power     s = a z^p − a(θ+z)^p (A=−ap, w=z,   σ=+1, γ=p−1), p<0
      saturating     s = a z^p − a(z−θ)^p (A=ap,  w=z,   σ=−1, γ=p−1), p>1

``StackedSpeedup``
    The per-job union (paper §7): σ is a ±1 tensor leaf as well, so one
    object mixes all five rows across the jobs of one instance.

``GenericSpeedup``
    Arbitrary concave ``s`` from callables on tensors; ``ds_inv`` is a
    fixed-count bisection on ``[0, B]``.

Speedups are frozen dataclasses whose parameters are tensors ("leaves").
A leaf's *shape* says what it indexes: a 0-dim leaf is shared, an
``(M,)`` leaf is job-indexed, and the batched planners add a leading
instance axis (``(N,)`` per-instance, ``(N, M)`` per-instance-per-job).
Every method is elementwise, so leaves broadcast against θ.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from .._device import as_tensor, resolve_device, stops_early, vpow

__all__ = [
    "Speedup",
    "RegularSpeedup",
    "StackedSpeedup",
    "GenericSpeedup",
    "power",
    "shifted_power",
    "log_speedup",
    "neg_power",
    "saturating",
    "from_roofline",
    "stack_speedups",
    "stack_speedup_rows",
    "broadcast_speedup",
    "collapse_homogeneous",
    "is_per_job",
    "inner_per_job",
    "take_job",
    "rowwise",
    "leaves",
    "map_leaves",
    "unchecked",
    "host_call",
    "per_instance",
]


class Speedup:
    """Common interface.  Subclasses implement s, ds and ds_inv."""

    B: float  # domain upper bound (server bandwidth)
    LEAVES: tuple = ()

    def s(self, theta):  # service rate
        raise NotImplementedError

    def ds(self, theta):  # derivative s'(θ)
        raise NotImplementedError

    def ds_inv(self, y):  # inverse of s' (s' is strictly decreasing)
        raise NotImplementedError

    def ds0(self):
        """s'(0); may be +inf (e.g. pure power laws)."""
        return self.ds(torch.zeros((), dtype=torch.float64,
                                   device=self.device))

    @property
    def device(self):
        """Device of the parameter leaves (None for leaf-less speedups)."""
        for l in leaves(self):
            return l.device
        return None

    @property
    def dtype(self):
        for l in leaves(self):
            return l.dtype
        return torch.float64

    def check_concave(self, n: int = 1025, b: float | None = None) -> bool:
        """Numerical sanity check of the paper's assumptions on [0, B]."""
        b = self.B if b is None else b
        th = torch.linspace(0.0, b, n, dtype=self.dtype,
                            device=self.device or "cpu")
        sv = self.s(th)
        dv = self.ds(th)
        ok = bool(torch.all(dv > 0))
        ok &= bool(torch.all(torch.diff(dv)
                             <= 1e-9 * torch.clamp_min(dv[:-1], 1.0)))
        ok &= abs(float(self.s(torch.zeros_like(th[:1]))[0])) < 1e-12
        ok &= bool(torch.all(torch.diff(sv) > 0))
        return ok


def _regular_ds(A, w, gamma, sigma, theta):
    """s'(θ) = A (w + σθ)^γ, elementwise in every parameter."""
    return A * vpow(w + sigma * theta, gamma)


def _regular_s(A, w, gamma, sigma, theta):
    """Antiderivative of ``_regular_ds`` with s(0) = 0, elementwise.

    γ == −1 (log family) takes the log branch, selected per entry so
    per-job parameters can mix log and power families in one call.  The
    log argument is guarded against w == 0 so the discarded branch of an
    invalid object cannot NaN the selected one.
    """
    base = w + sigma * theta
    g1 = gamma + 1.0
    w_safe = torch.where(w > 0, w, torch.ones_like(w))
    log_branch = (A / sigma) * (torch.log(base) - torch.log(w_safe))
    is_log = torch.abs(g1) < 1e-12
    safe_g1 = torch.where(is_log, torch.ones_like(g1), g1)
    pow_branch = (A / (sigma * safe_g1)) * (vpow(base, safe_g1)
                                            - vpow(w, safe_g1))
    return torch.where(is_log, log_branch, pow_branch)


def _regular_ds_inv(A, w, gamma, sigma, y):
    """Inverse of ``_regular_ds``: θ = σ((y/A)^{1/γ} − w), elementwise."""
    return sigma * (vpow(y / A, 1.0 / gamma) - w)


def _validate_log_family(w, gamma) -> None:
    """The log family (γ = −1) needs w > 0: s integrates log(w+σθ)−log(w)."""
    wv = w.detach().cpu().numpy()
    gv = gamma.detach().cpu().numpy()
    if wv.size == 0 or gv.size == 0:
        return
    wb, gb = np.broadcast_arrays(wv, gv)
    if np.any((np.abs(gb + 1.0) < 1e-12) & (wb <= 0)):
        raise ValueError(
            "log-family speedup (γ = −1) requires a positive shift w "
            "(s integrates through log(w + σθ) − log(w), which is NaN "
            "at w = 0)")


@dataclasses.dataclass(frozen=True)
class RegularSpeedup(Speedup):
    """s'(θ) = A (w + σ θ)^γ  with  A>0, σ∈{±1}, σγ<0, w+σθ>0 on [0,B]."""

    A: torch.Tensor
    w: torch.Tensor
    gamma: torch.Tensor
    sigma: int   # +1 or −1, shared by every job
    B: float

    LEAVES = ("A", "w", "gamma")

    def __post_init__(self):
        if self.sigma not in (+1, -1):
            raise ValueError("sigma must be ±1")
        _validate_log_family(self.w, self.gamma)

    def ds(self, theta):
        return _regular_ds(self.A, self.w, self.gamma, self.sigma, theta)

    def s(self, theta):
        return _regular_s(self.A, self.w, self.gamma, self.sigma, theta)

    def ds_inv(self, y):
        return _regular_ds_inv(self.A, self.w, self.gamma, self.sigma, y)

    def ds0(self):
        if self.sigma == +1:
            # γ<0: s'(0) = A·w^γ = +inf when w == 0.
            return torch.where(
                self.w > 0, self.A * vpow(torch.clamp_min(self.w, 1e-300),
                                          self.gamma),
                torch.full_like(self.A, torch.inf))
        return self.A * vpow(self.w, self.gamma)

    # GWF rectangle-bottle geometry (paper §4.3/4.5.1)
    def bottle_width(self, c):
        """u_i = c_i^{1/γ}."""
        return vpow(c, 1.0 / self.gamma)

    def bottle_bottom(self, c):
        """h_i = σ·w / u_i."""
        return self.sigma * self.w / self.bottle_width(c)


@dataclasses.dataclass(frozen=True)
class StackedSpeedup(Speedup):
    """Per-job family union (paper §7): s_i'(θ) = A_i (w_i + σ_i θ)^{γ_i}.

    ``RegularSpeedup`` with σ promoted to a ±1 tensor leaf, so one object
    can mix all five Table-1 rows (the saturating σ=−1 row included).
    There is no shared auxiliary curve, so the CAP over it is solved by
    λ-bisection or the sorted-breakpoint solver in ``core/gwf.py``.
    """

    A: torch.Tensor
    w: torch.Tensor
    gamma: torch.Tensor
    sigma: torch.Tensor
    B: float

    LEAVES = ("A", "w", "gamma", "sigma")

    def __post_init__(self):
        sg = self.sigma.detach().cpu().numpy()
        if sg.size and not np.all(np.isin(sg, (1.0, -1.0))):
            raise ValueError("sigma entries must be ±1")
        _validate_log_family(self.w, self.gamma)

    def ds(self, theta):
        return _regular_ds(self.A, self.w, self.gamma, self.sigma, theta)

    def s(self, theta):
        return _regular_s(self.A, self.w, self.gamma, self.sigma, theta)

    def ds_inv(self, y):
        return _regular_ds_inv(self.A, self.w, self.gamma, self.sigma, y)

    def ds0(self):
        # σ=+1, γ<0, w=0 (pure power): s'(0) = +∞; the σ=−1 saturating
        # family always has w = z ≥ B > 0, so the finite branch covers it.
        return torch.where(
            self.w > 0, self.A * vpow(torch.clamp_min(self.w, 1e-300),
                                      self.gamma),
            torch.full_like(self.A, torch.inf))


@dataclasses.dataclass(frozen=True)
class GenericSpeedup(Speedup):
    """Arbitrary concave speedup from callables (s_fn, ds_fn) on tensors.

    ``ds_inv`` runs a fixed-count bisection on [0, B] (s' strictly
    decreasing), vectorized over any shape of ``y``.
    """

    s_fn: Callable
    ds_fn: Callable
    B: float = 1.0
    inv_iters: int = 80

    def s(self, theta):
        return self.s_fn(theta)

    def ds(self, theta):
        return self.ds_fn(theta)

    def ds_inv(self, y):
        lo = torch.zeros_like(y)
        hi = torch.full_like(y, self.B)
        for _ in range(self.inv_iters):
            mid = 0.5 * (lo + hi)
            right = self.ds_fn(mid) > y      # s' decreasing: solution right of mid
            lo2 = torch.where(right, mid, lo)
            hi2 = torch.where(right, hi, mid)
            fixed = (lo2 == lo) & (hi2 == hi)
            lo, hi = lo2, hi2
            if stops_early(fixed):
                break
        mid = 0.5 * (lo + hi)
        # clamp outside the representable range of s' on [0, B]
        mid = torch.where(y >= self.ds_fn(torch.zeros_like(y)),
                          torch.zeros_like(mid), mid)
        mid = torch.where(y <= self.ds_fn(torch.full_like(y, self.B)),
                          torch.full_like(mid, self.B), mid)
        return mid


# ---------------------------------------------------------------------------
# Leaf plumbing (per-job §7 heterogeneity and batched instances)
# ---------------------------------------------------------------------------

def leaves(sp) -> list:
    """The parameter tensors of ``sp`` in a fixed order."""
    return [getattr(sp, name) for name in sp.LEAVES]


def unchecked(cls, **fields):
    """A speedup of class ``cls`` built without its construction checks.

    The checks read the parameters on the host; solver code that derives
    one valid object from another (a reshape, a broadcast) skips them so
    that nothing syncs to the host inside a solve.
    """
    obj = object.__new__(cls)
    for name, val in fields.items():
        object.__setattr__(obj, name, val)
    return obj


def map_leaves(sp, fn):
    """A copy of ``sp`` with ``fn`` applied to every leaf (unchecked)."""
    if not sp.LEAVES:
        return sp
    return unchecked(type(sp), **{
        f.name: fn(getattr(sp, f.name)) if f.name in sp.LEAVES
        else getattr(sp, f.name) for f in dataclasses.fields(sp)})


def host_call(sp, method: str, *args) -> np.ndarray:
    """``sp.<method>(*args)`` for numpy arguments, as a float64 array.

    The arguments go to the device of ``sp``'s leaves (the CPU for a
    leaf-less speedup) in its dtype; the result comes back to the host.
    For the host-side oracles (CDR check, heSRPT, reference simulator).
    """
    dev = sp.device or torch.device("cpu")
    ts = [torch.as_tensor(np.asarray(a, dtype=np.float64), device=dev,
                          dtype=sp.dtype) for a in args]
    out = getattr(sp, method)(*ts)
    return out.detach().cpu().numpy().astype(np.float64)


def per_instance(sp, N: int, nd: int = 1):
    """Per-instance ``(N,)`` leaves reshaped to ``(N,) + (1,) * nd``.

    Batched solvers keep instances on the leading axis: with ``nd`` = 1
    every leaf then broadcasts against ``(N, k)`` job arrays (scalars
    shared, ``(N, 1)`` per instance, ``(k,)``/``(N, k)`` per job), with
    ``nd`` = 0 against ``(N,)`` and with ``nd`` = 2 against ``(N, ·, ·)``.
    """
    return map_leaves(sp, lambda l: l.reshape((N,) + (1,) * nd)
                      if (l.ndim == 1 and l.shape[0] == N) else l)


def is_per_job(sp) -> bool:
    """True iff any leaf of ``sp`` is job-indexed (ndim ≥ 1)."""
    return any(l.ndim >= 1 for l in leaves(sp))


def inner_per_job(sp, n_instances: int | None = None) -> bool:
    """``is_per_job`` as seen by one instance of a batched solve.

    A leading ``n_instances`` axis holds per-instance scalars; a leaf is
    job-indexed iff it still has a dimension after that axis is
    stripped.  (The N == M ambiguity for 1-D leaves is rejected upstream
    by ``check_axes_unambiguous``.)
    """
    for l in leaves(sp):
        nd = l.ndim
        if n_instances is not None and nd >= 1 and l.shape[0] == n_instances:
            nd -= 1
        if nd >= 1:
            return True
    return False


def take_job(sp, i):
    """Job ``i``'s own speedup from a per-job one (identity when shared)."""
    return map_leaves(sp, lambda l: l[..., i] if l.ndim >= 1 else l)


def rowwise(sp):
    """Per-job leaves reshaped ``(M,) → (M, 1)`` for row-wise broadcast."""
    return map_leaves(sp, lambda l: l[..., :, None] if l.ndim >= 1 else l)


def broadcast_speedup(sp: Speedup, M: int):
    """Job-indexed view of a shared speedup: scalar leaves broadcast to (M,)."""
    return map_leaves(sp, lambda l: l.expand(M) if l.ndim == 0 else l)


def collapse_homogeneous(sp):
    """Collapse constant job-indexed leaves back to scalars.

    A per-job object whose every leaf is constant describes a homogeneous
    instance; collapsing routes it through the shared-function paths
    exactly as a scalar-leaf object.  A ``StackedSpeedup`` with uniform
    σ collapses all the way down to a ``RegularSpeedup``.  Reads the
    leaves on the host (an entry-point check, not a solver step).
    """
    ls = leaves(sp)
    if not any(l.ndim >= 1 for l in ls):
        return sp
    if not all(l.numel() > 0 and bool(torch.all(l == l.reshape(-1)[0]))
               for l in ls):
        return sp
    collapsed = map_leaves(sp, lambda l: l.reshape(-1)[0].clone())
    if isinstance(collapsed, StackedSpeedup):
        return RegularSpeedup(A=collapsed.A, w=collapsed.w,
                              gamma=collapsed.gamma,
                              sigma=int(float(collapsed.sigma)),
                              B=collapsed.B)
    return collapsed


def stack_speedups(sps, B: float | None = None) -> StackedSpeedup:
    """Stack per-job scalar ``RegularSpeedup`` objects into a StackedSpeedup.

    Raises TypeError for members that are not ``RegularSpeedup`` and
    ValueError for job-indexed members or mixed bounds without ``B``.
    """
    sps = list(sps)
    if not sps:
        raise ValueError("stack_speedups needs at least one speedup")
    for i, s in enumerate(sps):
        if not isinstance(s, RegularSpeedup):
            raise TypeError(
                f"job {i}: {type(s).__name__} cannot be stacked into a "
                "per-job speedup — only RegularSpeedup members have the "
                "closed-form per-job derivative inverse the heterogeneous "
                "CAP solver needs (fit a regular family first, e.g. via "
                "core.hesrpt.fit_power)")
        if is_per_job(s):
            raise ValueError(f"job {i}: member is already job-indexed; "
                             "stack scalar-parameter speedups")
    if B is None:
        bounds = {float(s.B) for s in sps}
        if len(bounds) > 1:
            raise ValueError(
                f"members carry different bounds {sorted(bounds)}; pass an "
                "explicit B for the stacked speedup")
        B = bounds.pop()
    ref = sps[0].A
    return StackedSpeedup(
        A=torch.stack([s.A.to(ref) for s in sps]),
        w=torch.stack([s.w.to(ref) for s in sps]),
        gamma=torch.stack([s.gamma.to(ref) for s in sps]),
        sigma=torch.tensor([float(s.sigma) for s in sps], dtype=ref.dtype,
                           device=ref.device),
        B=float(B))


# A valid (shifted-power-like) family for slots no real job occupies:
# padded parameters must stay legal members so a masked solve cannot NaN.
_NEUTRAL_PARAMS = (1.0, 1.0, -0.5, 1.0)         # (A, w, γ, σ)


def stack_speedup_rows(rows, M: int, B: float, device=None) -> StackedSpeedup:
    """(N, M)-leaved ``StackedSpeedup`` from per-instance member lists.

    ``rows[n]`` lists instance n's per-job ``RegularSpeedup`` members in
    row (completion) order; rows shorter than ``M`` edge-replicate their
    last member into the padded slots, and empty rows hold neutral valid
    family parameters.  Members are validated as in ``stack_speedups``.
    The leaves are float64 on ``device`` (default: the members' device,
    else CUDA).
    """
    N = len(rows)
    pars = np.empty((4, N, M))
    pars[0], pars[1], pars[2], pars[3] = (
        p for p in np.asarray(_NEUTRAL_PARAMS))
    for n, members in enumerate(rows):
        if len(members) > M:
            raise ValueError(f"row {n} has {len(members)} members for "
                             f"{M} slots")
        for r, s in enumerate(members):
            if not isinstance(s, RegularSpeedup) or is_per_job(s):
                # reuse stack_speedups' error text for the same contract
                stack_speedups([s], B=B)
            pars[0, n, r] = float(s.A)
            pars[1, n, r] = float(s.w)
            pars[2, n, r] = float(s.gamma)
            pars[3, n, r] = float(s.sigma)
        for r in range(len(members), M):
            if members:                 # edge-replicate the last member
                pars[:, n, r] = pars[:, n, len(members) - 1]
    dev = resolve_device(device, *(s for members in rows for s in members))
    A, w, gamma, sigma = (as_tensor(p, dev) for p in pars)
    return StackedSpeedup(A=A, w=w, gamma=gamma, sigma=sigma, B=float(B))


# ---------------------------------------------------------------------------
# Named constructors (Table 1 of the paper)
# ---------------------------------------------------------------------------

def _regular(A, w, gamma, sigma, B, device, dtype):
    dev = resolve_device(device)
    return RegularSpeedup(A=as_tensor(A, dev, dtype), w=as_tensor(w, dev, dtype),
                          gamma=as_tensor(gamma, dev, dtype), sigma=sigma, B=B)


def power(a: float, p: float, B: float, device=None,
          dtype=torch.float64) -> RegularSpeedup:
    """s(θ) = a θ^p, 0<p<1 — the heSRPT family [Berg et al. 2020]."""
    if not (0 < p < 1 and a > 0):
        raise ValueError("power needs 0 < p < 1 and a > 0")
    return _regular(a * p, 0.0, p - 1.0, +1, B, device, dtype)


def shifted_power(a: float, z: float, p: float, B: float, device=None,
                  dtype=torch.float64) -> RegularSpeedup:
    """s(θ) = a(θ+z)^p − a z^p, 0<p<1, z≥0."""
    if not (0 < p < 1 and a > 0 and z >= 0):
        raise ValueError("shifted_power needs 0 < p < 1, a > 0, z ≥ 0")
    return _regular(a * p, z, p - 1.0, +1, B, device, dtype)


def log_speedup(a: float, p: float, B: float, device=None,
                dtype=torch.float64) -> RegularSpeedup:
    """s(θ) = a ln(pθ + 1)."""
    if not (a > 0 and p > 0):
        raise ValueError("log_speedup needs a > 0 and p > 0")
    return _regular(a, 1.0 / p, -1.0, +1, B, device, dtype)


def neg_power(a: float, z: float, p: float, B: float, device=None,
              dtype=torch.float64) -> RegularSpeedup:
    """s(θ) = a z^p − a(θ+z)^p, p<0, z>0.  Includes s=θ/(θ+1)."""
    if not (p < 0 and a > 0 and z > 0):
        raise ValueError("neg_power needs p < 0, a > 0, z > 0")
    return _regular(-a * p, z, p - 1.0, +1, B, device, dtype)


def saturating(a: float, z: float, p: float, B: float, device=None,
               dtype=torch.float64) -> RegularSpeedup:
    """s(θ) = a z^p − a(z−θ)^p, p>1, z≥B.  Includes s=2θ−θ²."""
    if not (p > 1 and a > 0 and z >= B):
        raise ValueError("saturating needs p > 1, a > 0, z ≥ B")
    return _regular(a * p, z, p - 1.0, -1, B, device, dtype)


def from_roofline(
    tokens_per_step: float,
    step_flops: float,
    grad_bytes: float,
    B: float,
    peak_flops: float = 989e12,
    link_bw: float = 450e9,
    overlap: float = 0.0,
    device=None,
    dtype=torch.float64,
) -> RegularSpeedup:
    """Speedup function of a data-parallel training job on θ GPUs.

    step_time(θ) = F/(θ·R) + (1−overlap)·2·P·(θ−1)/(θ·W)   (ring all-reduce)
    s(θ) = T / step_time(θ) = A·θ / (D + C·θ)

    which is Table 1's neg_power row with p = −1.  The defaults are one
    H100 SXM: 989 TFLOP/s dense bf16 and 450 GB/s NVLink each way.
    """
    C = (1.0 - overlap) * 2.0 * grad_bytes / link_bw  # comm seconds (asymptotic)
    D = step_flops / peak_flops - C                   # F/R − C
    if D <= 0:
        # comm fully hidden or dominant from θ=1: a nearly linear
        # regular function (compute-bound all the way).
        return neg_power(a=tokens_per_step / C, z=1e6, p=-1.0, B=B,
                         device=device, dtype=dtype)
    z = D / C
    a = tokens_per_step / C * z
    return neg_power(a=a, z=z, p=-1.0, B=B, device=device, dtype=dtype)
