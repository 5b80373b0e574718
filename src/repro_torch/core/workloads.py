"""Seeded random workload ensembles (paper §6/§7 evaluation setup).

``sample_workloads`` draws K padded scheduling instances — sizes,
weights, arrival times and, optionally, per-instance or per-job speedup
parameters — shaped for ``smartfill_batched`` and
``smartfill_hetero_batched``:

  * X, W, arrival: (K, M) numpy arrays; real jobs occupy the prefix
    0..m_k−1 of each row (sizes non-increasing), padding is exact zeros;
  * weights follow the prefix sorted non-decreasing, so every instance
    is agreeable (per-job speedups re-rank by normalized size at plan
    time instead);
  * ``sp`` is None, or one speedup whose float64 leaves lie on the
    requested device: (K,) per instance (``per_job=False``), or (K, M)
    per job (``per_job=True``, paper §7), padded job slots replicating
    the last live draw so a masked solve never meets an invalid family.
    σ=+1 draws give a ``RegularSpeedup``; once ``"saturating"`` (σ=−1)
    joins the mix a ``StackedSpeedup`` carries σ per draw.

One integer seed drives ``np.random.default_rng``, and the draws are
made in the same order as the JAX package's sampler, so both packages
plan the same arrays bit for bit.  Generation runs on the host; only the
finished speedup leaves go to the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .._device import as_tensor, resolve_device
from .speedup import RegularSpeedup, StackedSpeedup

__all__ = ["WorkloadBatch", "sample_workloads", "FAMILIES"]

FAMILIES = ("power", "shifted", "log", "neg_power", "saturating")


@dataclasses.dataclass(frozen=True)
class WorkloadBatch:
    """K padded instances + optional per-instance/per-job speedup params."""

    X: np.ndarray            # (K, M) sizes, prefix sorted non-increasing
    W: np.ndarray            # (K, M) weights, prefix sorted non-decreasing
    arrival: np.ndarray      # (K, M) release times (0 ⇒ present at start)
    m: np.ndarray            # (K,) live-job counts
    B: float
    sp: RegularSpeedup | StackedSpeedup | None  # leaves (K,) or (K, M)

    def __len__(self) -> int:
        return int(self.X.shape[0])

    @property
    def active(self) -> np.ndarray:
        """(K, M) prefix masks (the batched-API convention)."""
        return np.arange(self.X.shape[1])[None, :] < self.m[:, None]


def _sample_family_params(rng, n: int, family, B: float):
    """(A, w, gamma, sigma) arrays for ``n`` draws of ``family``.

    ``family`` may be one name or a sequence to mix uniformly; σ is −1
    for saturating draws and +1 otherwise.
    """
    fams = (family,) if isinstance(family, str) else tuple(family)
    for f in fams:
        if f not in FAMILIES:
            raise ValueError(f"unknown speedup family {f!r}; use {FAMILIES}")
    pick = rng.integers(0, len(fams), n)
    A = np.empty(n)
    w = np.empty(n)
    gamma = np.empty(n)
    sigma = np.ones(n)
    a = rng.uniform(0.5, 2.0, n)
    p01 = rng.uniform(0.3, 0.9, n)          # exponents for 0<p<1 families
    z = rng.uniform(0.5, 6.0, n)
    pl = rng.uniform(0.3, 2.0, n)           # log slope
    pn = rng.uniform(-2.0, -0.5, n)         # negative-power exponents
    ps = rng.uniform(1.2, 2.5, n)           # saturating exponents (p > 1)
    zs = rng.uniform(1.2 * B, 3.0 * B, n)   # saturating shifts (z > B)
    for k in range(n):
        f = fams[pick[k]]
        if f == "power":                    # s = aθ^p
            A[k], w[k], gamma[k] = a[k] * p01[k], 0.0, p01[k] - 1.0
        elif f == "shifted":                # s = a(θ+z)^p − az^p
            A[k], w[k], gamma[k] = a[k] * p01[k], z[k], p01[k] - 1.0
        elif f == "log":                    # s = a ln(pθ+1)
            A[k], w[k], gamma[k] = a[k], 1.0 / pl[k], -1.0
        elif f == "neg_power":              # s = az^p − a(θ+z)^p
            A[k], w[k], gamma[k] = -a[k] * pn[k], z[k], pn[k] - 1.0
        else:                               # saturating: s = az^p − a(z−θ)^p
            A[k], w[k], gamma[k] = a[k] * ps[k], zs[k], ps[k] - 1.0
            sigma[k] = -1.0
    return A, w, gamma, sigma


def _family_speedup(A, w, gamma, sigma, B: float, device):
    """RegularSpeedup when σ is uniformly +1, else a StackedSpeedup;
    float64 leaves on ``device``."""
    A, w, gamma = (as_tensor(x, device) for x in (A, w, gamma))
    if np.all(sigma == 1.0):
        return RegularSpeedup(A=A, w=w, gamma=gamma, sigma=+1, B=B)
    return StackedSpeedup(A=A, w=w, gamma=gamma,
                          sigma=as_tensor(sigma, device), B=B)


def sample_workloads(
    seed: int,
    K: int,
    M: int,
    *,
    B: float = 10.0,
    family=None,
    per_job: bool = False,
    size_range: tuple = (0.5, 20.0),
    weights: str = "slowdown",
    m_range: tuple | None = None,
    arrival_rate: float = 0.0,
    device=None,
) -> WorkloadBatch:
    """Draw K padded scheduling instances from one seed.

    Args:
      seed, K, M: rng seed, instance count, padded width.
      B: server bandwidth recorded on the batch (and on ``sp``).
      family: None → ``sp`` is None (the caller supplies a shared server
        model); a name from ``FAMILIES`` or a sequence of names → drawn
        speedup parameters, mixing families uniformly when several are
        given (with ``"saturating"`` in the mix ``sp`` is stacked).
      per_job: False → one draw per instance ((K,) leaves); True → one
        draw per job ((K, M) leaves, paper §7), padded job slots
        edge-replicating the last live draw.
      size_range: uniform job-size support.
      weights: 'slowdown' → w = 1/x (always agreeable); 'random' →
        independent U(0.1, 5) weights sorted to keep the instance
        agreeable.
      m_range: (lo, hi) live-job counts per instance (inclusive);
        default every instance carries M jobs.
      arrival_rate: 0 → all jobs present at t=0; > 0 → every job gets a
        Poisson release time, randomly paired with the size slots; one
        release time is always 0 so the instance starts non-empty.
      device: where ``sp``'s leaves go (default CUDA); unused when
        ``family`` is None.

    Returns a WorkloadBatch (numpy arrays; ``sp`` on ``device``).
    """
    rng = np.random.default_rng(seed)
    lo, hi = m_range if m_range is not None else (M, M)
    if not (1 <= lo <= hi <= M):
        raise ValueError(f"m_range must satisfy 1 ≤ lo ≤ hi ≤ {M}")
    m = rng.integers(lo, hi + 1, K)
    X = np.zeros((K, M))
    W = np.zeros((K, M))
    ARR = np.zeros((K, M))
    for k in range(K):
        mk = int(m[k])
        xs = np.sort(rng.uniform(*size_range, mk))[::-1]
        X[k, :mk] = xs
        if weights == "slowdown":
            W[k, :mk] = 1.0 / xs
        elif weights == "random":
            W[k, :mk] = np.sort(rng.uniform(0.1, 5.0, mk))
        else:
            raise ValueError("weights must be 'slowdown' or 'random'")
        if arrival_rate > 0 and mk > 1:
            times = np.cumsum(rng.exponential(1.0 / arrival_rate, mk))
            times[0] = 0.0                         # start non-empty
            ARR[k, :mk] = rng.permutation(times)
    sp = None
    if family is not None and not per_job:
        A, w, gamma, sigma = _sample_family_params(rng, K, family, B)
        sp = _family_speedup(A, w, gamma, sigma, B, resolve_device(device))
    elif family is not None:
        A, w, gamma, sigma = (np.empty((K, M)) for _ in range(4))
        for k in range(K):
            mk = int(m[k])
            Ak, wk, gk, sk = _sample_family_params(rng, mk, family, B)
            # edge-replicate the last live draw into padded slots
            A[k] = np.concatenate([Ak, np.repeat(Ak[-1], M - mk)])
            w[k] = np.concatenate([wk, np.repeat(wk[-1], M - mk)])
            gamma[k] = np.concatenate([gk, np.repeat(gk[-1], M - mk)])
            sigma[k] = np.concatenate([sk, np.repeat(sk[-1], M - mk)])
        sp = _family_speedup(A, w, gamma, sigma, B, resolve_device(device))
    return WorkloadBatch(X=X, W=W, arrival=ARR, m=m, B=float(B), sp=sp)
