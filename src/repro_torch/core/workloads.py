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

``sample_fault_traces`` draws seeded fault schedules (``FaultTrace``)
for the fault-aware engine, ``sample_arrival_stream`` /
``arrival_stream_from_log`` / ``load_arrival_log`` give the open-arrival
traces of the streaming control plane (``ArrivalStream``), and
``sample_class_workloads`` draws class-aggregated instances
(``ClassWorkloadBatch``, ``core/classes.py``).

One integer seed drives ``np.random.default_rng``, and the draws are
made in the same order as the JAX package's samplers, so both packages
see the same arrays bit for bit.  Generation runs on the host; only the
finished speedup leaves go to the device.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .._device import as_tensor, resolve_device
from .speedup import RegularSpeedup, StackedSpeedup, map_leaves

__all__ = ["WorkloadBatch", "ArrivalStream", "ClassWorkloadBatch",
           "sample_workloads", "sample_fault_traces", "sample_arrival_stream",
           "arrival_stream_from_log", "load_arrival_log",
           "sample_class_workloads", "FAMILIES"]

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


# ---------------------------------------------------------------------------
# Seeded chaos: fault-trace ensembles for the robust control plane
# ---------------------------------------------------------------------------

def sample_fault_traces(
    seed: int,
    K: int,
    M: int,
    *,
    B: float,
    horizon: float,
    preempt_rate: float = 0.0,
    fail_rate: float = 0.0,
    straggle_rate: float = 0.0,
    budget_frac: tuple = (0.25, 0.75),
    repair_time: float = 1.0,
    loss: tuple = (0.5, 1.0),
    slow: tuple = (0.2, 0.8),
    recover: bool = True,
    snap_to=None,
    snap_frac: float = 0.5,
):
    """Draw K seeded fault traces for the fault-aware scenario engine.

    Three independent Poisson processes over ``[0, horizon)`` per trace
    (the chaos analog of ``sample_workloads``' Poisson arrivals):

      * preemptions (``preempt_rate``): the budget drops to
        B·U(*budget_frac*); ``recover=True`` pairs each with a recovery
        event Exp(``repair_time``) later restoring the full ``B``.
      * job failures (``fail_rate``): a uniformly chosen job restarts,
        losing a U(*loss*) fraction of its completed work.
      * stragglers (``straggle_rate``): a uniformly chosen job's rate is
        scaled by U(*slow*); ``recover=True`` schedules the multiplier
        back to 1 Exp(``repair_time``) later.

    ``snap_to`` (optional array of timestamps, e.g. a workload's arrival
    times) snaps each drawn event time onto the nearest entry with
    probability ``snap_frac`` — the knob the coincident-event tests use
    to land budget steps exactly on arrivals/completions.

    Returns a batched ``FaultTrace`` with (K, S) arrays, S the largest
    per-trace event count (shorter traces are +inf-padded); one trace per
    workload of a ``simulate_ensemble`` call.
    """
    from .simulator import (FaultTrace, KIND_BUDGET, KIND_FAILURE,
                            KIND_STRAGGLER)

    if horizon <= 0:
        raise ValueError("horizon must be > 0")
    rng = np.random.default_rng(seed)
    snap = None if snap_to is None else np.sort(
        np.asarray(snap_to, np.float64).ravel())
    per_trace = []
    for _ in range(K):
        ts, ks, js, vs = [], [], [], []

        def emit(t, kind, job, value):
            ts.append(float(t))
            ks.append(int(kind))
            js.append(int(job))
            vs.append(float(value))

        def draw_time():
            t = rng.uniform(0.0, horizon)
            if snap is not None and snap.size and rng.random() < snap_frac:
                t = float(snap[np.argmin(np.abs(snap - t))])
            return t

        for _ in range(rng.poisson(preempt_rate * horizon)):
            t = draw_time()
            emit(t, KIND_BUDGET, 0, B * rng.uniform(*budget_frac))
            if recover:
                emit(t + rng.exponential(repair_time), KIND_BUDGET, 0, B)
        for _ in range(rng.poisson(fail_rate * horizon)):
            emit(draw_time(), KIND_FAILURE, rng.integers(0, M),
                 rng.uniform(*loss))
        for _ in range(rng.poisson(straggle_rate * horizon)):
            t = draw_time()
            j = int(rng.integers(0, M))
            emit(t, KIND_STRAGGLER, j, rng.uniform(*slow))
            if recover:
                emit(t + rng.exponential(repair_time), KIND_STRAGGLER, j, 1.0)
        order = np.argsort(np.asarray(ts, np.float64), kind="stable")
        per_trace.append((np.asarray(ts)[order], np.asarray(ks)[order],
                          np.asarray(js)[order], np.asarray(vs)[order]))
    S = max((t.size for t, *_ in per_trace), default=0)
    times = np.full((K, S), np.inf)
    kinds = np.zeros((K, S), np.int32)
    jobs = np.zeros((K, S), np.int32)
    values = np.zeros((K, S))
    for k, (t, kk, jj, vv) in enumerate(per_trace):
        n = t.size
        times[k, :n] = t
        kinds[k, :n] = kk
        jobs[k, :n] = jj
        values[k, :n] = vv
    return FaultTrace(times=times, kinds=kinds, jobs=jobs, values=values)


# ---------------------------------------------------------------------------
# Open-arrival streams (the streaming control plane)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ArrivalStream:
    """An open-arrival trace for the streaming control plane.

    Unlike ``WorkloadBatch`` (K closed instances, fixed event horizon)
    this is one *unbounded-style* trace: N timed arrivals over
    ``[0, horizon)``, each a (size, weight, deadline) job, plus an
    optional sequence of absolute server-budget steps (the B(t) the
    controller replans against).  The streaming control plane
    (``serve/stream.py``) consumes it.
    """

    t: np.ndarray             # (N,) arrival times, sorted non-decreasing
    x: np.ndarray             # (N,) job sizes
    w: np.ndarray             # (N,) weights
    deadline: np.ndarray      # (N,) absolute deadlines (+inf = none)
    horizon: float
    budget_times: np.ndarray  # (S,) budget-step times, sorted
    budget_values: np.ndarray  # (S,) absolute budget after each step

    def __len__(self) -> int:
        return int(self.t.size)


def sample_arrival_stream(
    seed: int,
    *,
    horizon: float = 86_400.0,
    rate: float = 0.01,
    diurnal: float = 0.75,
    period: float = 86_400.0,
    size_range: tuple = (0.5, 20.0),
    weights: str = "slowdown",
    deadline_slack: float | None = None,
    solo_rate: float = 1.0,
    B: float = 10.0,
    n_budget_events: int = 0,
    budget_frac: tuple = (0.35, 1.0),
) -> ArrivalStream:
    """Draw a day-long open-arrival trace from one seed.

    Arrivals follow a nonhomogeneous Poisson process with the diurnal
    intensity λ(t) = rate·(1 + diurnal·sin(2πt/period − π/2)) — a
    load trough at t = 0 rising to the (1+diurnal)·rate peak mid-period
    — sampled by thinning against the constant dominating rate.

    Args:
      horizon, rate, diurnal, period: trace length, mean arrival rate,
        relative peak-to-mean swing (0 → homogeneous Poisson), and the
        diurnal cycle length (defaults: one day of seconds).
      size_range: uniform job-size support.
      weights: 'slowdown' → w = 1/x (the heSRPT-slowdown objective's
        weighting), 'random' → independent U(0.1, 5), 'uniform' → 1
        (weighted J becomes total flow time).
      deadline_slack: None → no deadlines (+inf); a factor f → each job
        must finish by ``t + f·x/solo_rate`` (f× its hypothetical solo
        service time at rate ``solo_rate`` — pass the server's s(B)).
      B, n_budget_events, budget_frac: when ``n_budget_events`` > 0 the
        trace carries that many absolute budget steps at uniform times,
        each to B·U(*budget_frac*) followed by the paired recovery back
        to B — the streaming analog of ``sample_fault_traces``'
        preemptions, and the replanning events that invalidate carried
        λ-brackets.

    Returns an ArrivalStream (numpy; host-side setup, not the hot loop).
    """
    if horizon <= 0:
        raise ValueError("horizon must be > 0")
    if not 0.0 <= diurnal <= 1.0:
        raise ValueError("diurnal swing must be in [0, 1]")
    rng = np.random.default_rng(seed)
    lam_max = rate * (1.0 + diurnal)
    # homogeneous candidates at the dominating rate, thinned to λ(t)
    n_cand = rng.poisson(lam_max * horizon)
    cand = np.sort(rng.uniform(0.0, horizon, n_cand))
    lam = rate * (1.0 + diurnal * np.sin(
        2.0 * np.pi * cand / period - 0.5 * np.pi))
    keep = rng.uniform(0.0, lam_max, n_cand) < lam
    t = cand[keep]
    n = t.size
    x = rng.uniform(*size_range, n)
    if weights == "slowdown":
        w = 1.0 / x
    elif weights == "random":
        w = rng.uniform(0.1, 5.0, n)
    elif weights == "uniform":
        w = np.ones(n)
    else:
        raise ValueError("weights must be 'slowdown', 'random' or 'uniform'")
    if deadline_slack is None:
        deadline = np.full(n, np.inf)
    else:
        deadline = t + deadline_slack * x / float(solo_rate)
    bt = np.zeros(0)
    bv = np.zeros(0)
    if n_budget_events > 0:
        dips = np.sort(rng.uniform(0.0, horizon, n_budget_events))
        recov = dips + rng.exponential(0.02 * horizon, n_budget_events)
        bt = np.concatenate([dips, recov])
        bv = np.concatenate([B * rng.uniform(*budget_frac, n_budget_events),
                             np.full(n_budget_events, B)])
        order = np.argsort(bt, kind="stable")
        inside = bt[order] < horizon
        bt, bv = bt[order][inside], bv[order][inside]
    return ArrivalStream(t=t, x=x, w=w, deadline=deadline,
                         horizon=float(horizon), budget_times=bt,
                         budget_values=bv)


def arrival_stream_from_log(
    times,
    sizes,
    weights=None,
    *,
    deadlines=None,
    horizon: float | None = None,
    budget_times=(),
    budget_values=(),
) -> ArrivalStream:
    """Build an ArrivalStream from recorded arrival data (trace replay).

    The synthetic sampler covers parameter sweeps; production traces
    arrive as logs.  This constructor takes the raw columns — arrival
    times, job sizes, optional weights/deadlines — sorts them stably by
    time, validates them, and returns the same ``ArrivalStream`` the
    sampler gives, so a recorded log replays through the same control
    plane as a sampled trace.

    Args:
      times, sizes: (N,) arrival times and job sizes.  Any order; the
        result is stably time-sorted.  Sizes must be positive.
      weights: (N,) or None → the slowdown weighting w = 1/x.
      deadlines: (N,) absolute deadlines or None → no deadlines.
      horizon: trace end; None → just past the last logged event so
        the final arrival is still admitted.
      budget_times, budget_values: optional recorded B(t) step series.
    """
    t = np.asarray(times, dtype=float).ravel()
    x = np.asarray(sizes, dtype=float).ravel()
    if t.shape != x.shape:
        raise ValueError("times and sizes must have the same length")
    if t.size and not np.all(np.isfinite(t)):
        raise ValueError("arrival times must be finite")
    if np.any(x <= 0):
        raise ValueError("job sizes must be positive")
    w = (1.0 / x if weights is None
         else np.asarray(weights, dtype=float).ravel())
    d = (np.full(t.size, np.inf) if deadlines is None
         else np.asarray(deadlines, dtype=float).ravel())
    if w.shape != t.shape or d.shape != t.shape:
        raise ValueError("weights/deadlines must match times in length")
    if np.any(w <= 0):
        raise ValueError("weights must be positive")
    order = np.argsort(t, kind="stable")
    t, x, w, d = t[order], x[order], w[order], d[order]
    bt = np.asarray(budget_times, dtype=float).ravel()
    bv = np.asarray(budget_values, dtype=float).ravel()
    if bt.shape != bv.shape:
        raise ValueError("budget_times and budget_values must match")
    border = np.argsort(bt, kind="stable")
    bt, bv = bt[border], bv[border]
    if horizon is None:
        last = max(t[-1] if t.size else 0.0, bt[-1] if bt.size else 0.0)
        horizon = float(np.nextafter(last, np.inf)) if last > 0 else 1.0
    horizon = float(horizon)
    if t.size and t[-1] >= horizon:
        raise ValueError("all arrivals must land strictly before horizon")
    inside = bt < horizon
    return ArrivalStream(t=t, x=x, w=w, deadline=d, horizon=horizon,
                         budget_times=bt[inside], budget_values=bv[inside])


def load_arrival_log(path) -> ArrivalStream:
    """Read a recorded arrival log (CSV or JSON) into an ArrivalStream.

    CSV: a header row naming columns among ``t, x, w, deadline`` (the
    first two required), one arrival per line.  Budget steps ride as
    comment lines ``# budget <time> <value>`` so the one file carries
    the whole trace.  JSON: an object with the same keys as arrays,
    plus optional ``budget_times``/``budget_values``/``horizon``.
    """
    path = str(path)
    if path.endswith(".json"):
        import json
        with open(path) as fh:
            obj = json.load(fh)
        return arrival_stream_from_log(
            obj["t"], obj["x"], obj.get("w"),
            deadlines=obj.get("deadline"),
            horizon=obj.get("horizon"),
            budget_times=obj.get("budget_times", ()),
            budget_values=obj.get("budget_values", ()))
    import csv
    bt, bv, rows = [], [], []
    with open(path, newline="") as fh:
        header = None
        for line in fh:
            line = line.strip()
            if not line:
                continue
            if line.startswith("#"):
                parts = line[1:].split()
                if parts and parts[0] == "budget":
                    bt.append(float(parts[1]))
                    bv.append(float(parts[2]))
                continue
            if header is None:
                header = next(csv.reader([line]))
                if "t" not in header or "x" not in header:
                    raise ValueError("CSV header must name 't' and 'x'")
                continue
            rows.append(next(csv.reader([line])))
    if header is None:
        raise ValueError(f"no header row in {path}")
    col = {name: i for i, name in enumerate(header)}
    get = lambda name: [float(r[col[name]]) for r in rows]  # noqa: E731
    return arrival_stream_from_log(
        get("t"), get("x"),
        get("w") if "w" in col else None,
        deadlines=get("deadline") if "deadline" in col else None,
        budget_times=bt, budget_values=bv)


# replay entry point advertised on the sampler: recorded logs go
# through sample_arrival_stream.from_log, sweeps through the sampler
sample_arrival_stream.from_log = arrival_stream_from_log


# ---------------------------------------------------------------------------
# Class-structured ensembles (core/classes.py)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ClassWorkloadBatch:
    """K class-aggregated instances: per-class counts, sizes, weights.

    Zero-count classes are legitimate (and sampled by default): the
    planners treat them as inert padding.  ``sp`` leaves are (K, C),
    every class of every instance drawing its own family.
    """

    counts: np.ndarray       # (K, C) job counts: integral floats, 0 allowed
    sizes: np.ndarray        # (K, C) per-job remaining size within the class
    weights: np.ndarray      # (K, C) per-job weight within the class
    B: float
    sp: RegularSpeedup | StackedSpeedup     # (K, C) leaves

    def __len__(self) -> int:
        return int(self.counts.shape[0])

    @property
    def jobs(self) -> np.ndarray:
        """(K,) total job count per instance."""
        return self.counts.sum(axis=1)

    def state(self, k: int):
        """``ClassState`` of instance ``k`` (the single-instance APIs)."""
        from .classes import ClassState

        return ClassState(counts=self.counts[k], sizes=self.sizes[k],
                          weights=self.weights[k],
                          sp=map_leaves(self.sp, lambda l: l[k]), B=self.B)


def sample_class_workloads(
    seed: int,
    K: int,
    C: int,
    *,
    B: float = 10.0,
    family=FAMILIES,
    count_range: tuple = (0, 50),
    size_range: tuple = (0.5, 20.0),
    weights: str = "random",
    device=None,
) -> ClassWorkloadBatch:
    """Draw K class-structured instances from one seed.

    Args:
      seed, K, C: rng seed, instance count, classes per instance.
      B: server bandwidth recorded on the batch (and on ``sp``).
      family: name(s) from ``FAMILIES`` to mix uniformly per class
        (default all five, so σ=−1 saturating rows mix with σ=+1).
      count_range: (lo, hi) inclusive per-class job counts; lo = 0
        samples empty classes.  An instance drawn all empty gets one job
        in one class.
      size_range: uniform per-job size support within a class.
      weights: 'random' → independent U(0.1, 5) per class; 'slowdown' →
        w = 1/x.
      device: where ``sp``'s leaves go (default CUDA).

    Returns a ClassWorkloadBatch (numpy arrays; ``sp`` on ``device``):
    its arrays feed ``plan_classes_batched``, ``.state(k)`` the
    single-instance planner and the fluid executor.
    """
    rng = np.random.default_rng(seed)
    lo, hi = count_range
    if not (0 <= lo <= hi):
        raise ValueError("count_range must satisfy 0 ≤ lo ≤ hi")
    counts = rng.integers(lo, hi + 1, (K, C)).astype(np.float64)
    for k in range(K):                       # keep every instance non-empty
        if not (counts[k] > 0).any():
            counts[k, rng.integers(0, C)] = 1.0
    sizes = rng.uniform(*size_range, (K, C))
    if weights == "slowdown":
        W = 1.0 / sizes
    elif weights == "random":
        W = rng.uniform(0.1, 5.0, (K, C))
    else:
        raise ValueError("weights must be 'slowdown' or 'random'")
    A, w, gamma, sigma = (arr.reshape(K, C) for arr in
                          _sample_family_params(rng, K * C, family, B))
    sp = _family_speedup(A, w, gamma, sigma, B, resolve_device(device))
    return ClassWorkloadBatch(counts=counts, sizes=sizes, weights=W,
                              B=float(B), sp=sp)
