"""Fleet-sharding layer: partition the instance axis over a device mesh.

``smartfill_batched`` and ``simulate_ensemble`` are one-device calls over
a batch of instances.  At cloud scale the ensemble itself outgrows one
device — thousands of tenants planned per decision round, policy sweeps
over tens of thousands of workloads — so this module splits that axis
over a 1-D ``FleetMesh``:

``plan_sharded``
    ``smartfill_batched`` with instances partitioned across the mesh.
``plan_classes_sharded``
    ``plan_classes_batched``'s host preparation, then ``plan_sharded``.
``simulate_ensemble_sharded``
    ``simulate_ensemble`` with workloads partitioned across the mesh
    (policies stay a Python loop, as in the single-device runner).
``serve_streams_sharded``
    T tenant arrival streams, each through ``StreamController.
    run_device``'s event loop, tenants partitioned across the mesh.

All of them go through one driver (``_run_sharded``):

  * the instance count N is padded up to a multiple of the device count
    (and of the chunk size) — padded instances are **inert**: sizes,
    weights and live-job counts pad with zeros (m = 0 rows are masked
    no-ops inside the solver; size-0 jobs never run in the engine),
    while speedup/policy parameter leaves pad by edge replication so the
    padded rows still hold *valid* family parameters.  On the card the
    solver's loops run out their fixed counts, and a padded row stays
    finite through them without touching a live row; on the CPU it
    counts as done from the start, so the loops still stop early;
  * instances are laid out as ``n_chunks`` chunks of ``chunk`` rows, a
    Python loop over chunks, each chunk's rows split evenly over the
    mesh's devices — one call a device, the outputs gathered onto the
    first device — so ``chunk_size`` bounds the live working set;
  * there is **no cross-device communication**: every instance is an
    independent solve, so the sharded result equals the single-device
    result instance by instance.

Per-instance batching follows the ensemble convention: any leaf of
``sp`` or of a policy (a ladder's rungs and a wrapped policy included)
with leading dimension N is split alongside its instances; all other
leaves are replicated.

The mesh resolution order is: explicit ``mesh=`` argument, then the
innermost active ``with FleetMesh(...)`` context of one axis, then a
fresh one-device mesh on the device of the inputs (``fleet_mesh``).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .._device import as_tensor, resolve_device
from ..core.batch import (BatchedSmartFillSchedule, _prepare,
                          check_axes_unambiguous, hetero_order_batch,
                          validate_padded_instances)
from ..core.simulator import (EnsembleResult, _bound, _check_policy_budget,
                              _fault_B0, _fault_n_events, _objective,
                              _prepared_faults, _sim_core, _validate_budget,
                              _validate_workload, _warn_event_budget,
                              n_events_for)
from ..core.smartfill import _fast_ok, _on, _solve
from ..core.speedup import (Speedup, collapse_homogeneous, is_per_job,
                            map_leaves)
from .sharding import FleetMesh, active_mesh

__all__ = [
    "FLEET_AXIS",
    "FleetStreamResult",
    "active_fleet_mesh",
    "fleet_mesh",
    "plan_classes_sharded",
    "plan_sharded",
    "serve_streams_sharded",
    "simulate_ensemble_sharded",
]

FLEET_AXIS = "fleet"


def active_fleet_mesh() -> FleetMesh | None:
    """The innermost active ``with FleetMesh(...)`` when it is 1-D, else
    None.

    The dispatch predicate consumers use (``serve/admission.py``'s
    simulate estimator): a 1-D mesh context means "shard the instance
    axis here"; a multi-axis (model-parallel) mesh is somebody else's and
    is left alone.
    """
    mesh = active_mesh()
    if (mesh is not None and len(mesh.axis_names) == 1
            and getattr(mesh, "devices", None) is not None):
        return mesh
    return None


def fleet_mesh(n_devices: int | None = None, axis_name: str = FLEET_AXIS,
               device=None) -> FleetMesh:
    """A 1-D mesh: the instance-axis mesh the sharded entry points expect.

    On CUDA (the default) the first ``n_devices`` cards, all of them by
    default.  With ``device="cpu"`` the host device ``n_devices`` times
    (once by default): several shards on one host, the layout that
    exercises padding and chunking on a machine without cards.
    """
    dev = resolve_device(device)
    if dev.type == "cuda":
        devs = [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    else:
        devs = [dev] * (1 if n_devices is None else max(int(n_devices), 1))
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"asked for {n_devices} devices, only {len(devs)} present")
        devs = devs[:n_devices]
    return FleetMesh(devs, (axis_name,))


def _resolve_mesh(mesh: FleetMesh | None, *inputs) -> FleetMesh:
    """Explicit mesh, else the active 1-D mesh context, else a one-device
    mesh on the inputs' device (CUDA by default)."""
    if mesh is None:
        mesh = active_fleet_mesh()      # multi-axis: not ours
    if mesh is None:
        mesh = fleet_mesh(1, device=resolve_device(None, *inputs))
    if len(mesh.axis_names) != 1:
        raise ValueError(
            f"fleet sharding needs a 1-D mesh, got axes {mesh.axis_names}")
    return mesh


def _walk(tree, fn):
    """``fn`` over every numeric leaf of a speedup or a policy, in one
    fixed order (the policy's nested rungs included)."""
    if isinstance(tree, Speedup):
        return map_leaves(tree, fn)
    return tree.map_leaves(fn)


class _SplitLeaves:
    """Which leaves of a speedup or policy are per instance.

    A leaf is per instance iff it is an array or tensor whose leading
    dimension equals N (the ensemble-runner convention).  The verdict is
    taken once, on the caller's object, and applied by position to any
    object of the same structure (its padded copy, a chunk's slice), so
    a shared leaf never turns per-instance because a slice happens to
    have its length.
    """

    def __init__(self, tree, N: int):
        flags = []

        def note(l):
            flags.append(hasattr(l, "shape") and len(l.shape) >= 1
                         and l.shape[0] == N)
            return l

        _walk(tree, note)
        self.is_batched = tuple(flags)

    def map(self, tree, batched, shared=lambda l: l):
        """``tree`` with ``batched`` applied to its per-instance leaves and
        ``shared`` to the others."""
        it = iter(self.is_batched)
        return _walk(tree, lambda l: batched(l) if next(it) else shared(l))


def _pad_rows(leaf, total: int, edge: bool):
    """Pad a leading-dim-N leaf up to ``total`` rows.

    ``edge=True`` replicates the last row (speedup/policy parameters:
    padded instances keep *valid* family parameters so the solver cannot
    NaN on them); ``edge=False`` pads zeros (sizes/weights/counts: the
    inert-instance convention)."""
    leaf = torch.as_tensor(leaf)
    n = leaf.shape[0]
    if n == total:
        return leaf
    if edge:
        tail = leaf[-1:].expand((total - n,) + tuple(leaf.shape[1:]))
    else:
        tail = torch.zeros((total - n,) + tuple(leaf.shape[1:]),
                           dtype=leaf.dtype, device=leaf.device)
    return torch.cat([leaf, tail], 0)


def _chunk_layout(N: int, D: int, chunk_size: int | None):
    """(total, n_chunks, chunk): instance-axis padding plan.

    ``chunk`` is the instances of one step over the whole mesh — a
    multiple of the device count D, defaulting to everything in one
    step.  ``total`` = n_chunks · chunk ≥ N is what the instance axis
    pads to."""
    if N < 1:
        raise ValueError("need at least one instance")
    if chunk_size is None:
        chunk = math.ceil(N / D) * D
    else:
        if chunk_size < 1:
            raise ValueError("chunk_size must be ≥ 1")
        chunk = math.ceil(chunk_size / D) * D
    n_chunks = math.ceil(N / chunk)
    return n_chunks * chunk, n_chunks, chunk


def _run_sharded(mesh: FleetMesh, fn, N: int, chunk_size: int | None):
    """Drive ``fn`` over the instance axis: chunks → devices.

    ``fn(lo, hi, dev)`` solves the padded rows lo..hi on ``dev`` and
    returns a tuple of (hi − lo, …) tensors.  Chunks run in order; a
    chunk's rows split evenly over the mesh's devices, one call each.
    Returns the outputs gathered on the first device, concatenated and
    trimmed back to N rows.
    """
    devs = list(mesh.devices.flat)
    D = len(devs)
    _, n_chunks, chunk = _chunk_layout(N, D, chunk_size)
    per = chunk // D
    outs = []
    for c in range(n_chunks):
        for d, dev in enumerate(devs):
            lo = c * chunk + d * per
            outs.append(fn(lo, lo + per, dev))
    home = devs[0]
    return tuple(torch.cat([o[i].to(home) for o in outs], 0)[:N]
                 for i in range(len(outs[0])))


def _rows(lo: int, hi: int, dev, M: int):
    """Leaf maps of one device's slice: per-instance leaves take rows
    lo..hi; shared leaves move as they are, except that a shared
    job-indexed (M,) leaf is given to every row when the slice has M
    rows (where a (rows,) leaf would read as per-instance)."""
    n = hi - lo

    def batched(l):
        return l[lo:hi].to(dev)

    def shared(l):
        if not isinstance(l, torch.Tensor):
            return l
        if l.ndim == 1 and l.shape[0] == M == n:
            l = l.expand(n, M)
        return l.to(dev)

    return batched, shared


# ---------------------------------------------------------------------------
# Sharded batched planning
# ---------------------------------------------------------------------------

def plan_sharded(
    sp,
    X,
    W,
    B=None,
    active=None,
    *,
    mesh: FleetMesh | None = None,
    chunk_size: int | None = None,
    coarse: int = 32,
    descent_iters: int = 40,
    cap_iters: int = 64,
    fast_path: bool | None = None,
    validate: bool = False,
    stol_rel: float | None = None,
) -> BatchedSmartFillSchedule:
    """``smartfill_batched`` with the instance axis sharded over a mesh.

    Same contract and padding convention as ``smartfill_batched`` (see
    ``repro_torch.core.batch``); per-instance speedup parameters — sp
    leaves with leading dimension N, per-job (N, M) leaves included —
    shard alongside their instances.  Extra knobs:

      mesh: 1-D device mesh (default: the active mesh context, else one
        device: the inputs', CUDA by default).
      chunk_size: instances per step over the whole mesh, for sweeps
        larger than memory; rounded up to a multiple of the device
        count.  None ⇒ one step.

    Instance by instance the computation is the single-device one, so
    results match ``smartfill_batched`` (the differential guarantee
    ``tests/test_torch_fleet.py`` pins).  The schedule lives on the
    mesh's first device.
    """
    mesh = _resolve_mesh(mesh, X, sp)
    home = mesh.devices.flat[0]
    Xm, Wm, active, m = _prepare(X, W, active, home)
    N, M = Xm.shape
    Bv = as_tensor(sp.B if B is None else B, home, Xm.dtype).expand(N)
    if validate:
        validate_padded_instances(Xm, Wm, m)
    sp = collapse_homogeneous(_on(sp, home, Xm.dtype))
    check_axes_unambiguous(sp, N, M, "sp")
    D = mesh.size
    total, _, _ = _chunk_layout(N, D, chunk_size)
    fast = _fast_ok(sp, N) and fast_path is not False

    split = _SplitLeaves(sp, N)
    sp_pad = split.map(sp, lambda l: _pad_rows(l, total, edge=True))
    Xp = _pad_rows(Xm, total, edge=False)
    Wp = _pad_rows(Wm, total, edge=False)
    Bp = _pad_rows(Bv, total, edge=True)        # a valid budget, masked off
    mp = _pad_rows(m, total, edge=False)        # m = 0 ⇒ inert instance

    def one(lo, hi, dev):
        spv = split.map(sp_pad, *_rows(lo, hi, dev, M))
        out = _solve(spv, Xp[lo:hi].to(dev), Wp[lo:hi].to(dev),
                     Bp[lo:hi].to(dev).contiguous(), mp[lo:hi].to(dev),
                     coarse, descent_iters, cap_iters, fast,
                     stol_rel=stol_rel)
        return out[:7]

    theta, c, a, d, T, J, J_lin = _run_sharded(mesh, one, N, chunk_size)
    return BatchedSmartFillSchedule(theta=theta, c=c, a=a, durations=d, T=T,
                                    J=J, J_linear=J_lin, active=active, m=m)


def plan_classes_sharded(
    counts,
    sizes,
    weights,
    sp,
    B=None,
    *,
    mesh: FleetMesh | None = None,
    chunk_size: int | None = None,
    **kwargs,
):
    """Class-aggregated batched planning, instance axis sharded over a mesh.

    The fleet front door for class aggregates (``core/classes.py``): the
    host-side preparation is ``plan_classes_batched``'s — live-first
    compaction of the (K, C) class slots, the aggregation transform on
    the speedup leaves, and the per-instance normalized-size order — and
    the aggregate batch then rides ``plan_sharded``.  Instance by
    instance the computation is the single-device one, so ``(orders,
    sched)`` match ``plan_classes_batched``.  μ* precision defaults match
    ``plan_classes_batched`` for the same reason.
    """
    from ..core.classes import compact_aggregate_batch

    if B is None:
        B = sp.B
    kwargs.setdefault("coarse", 64)
    kwargs.setdefault("descent_iters", 96)
    kwargs.setdefault("stol_rel", 1e-10)
    mesh = _resolve_mesh(mesh, sp)
    home = mesh.devices.flat[0]
    perm, sp_agg, X, W = compact_aggregate_batch(
        counts, sizes, weights, _on(sp, home, torch.float64))
    Xm, Wm, active, m = _prepare(X, W, None, home)
    sp_agg = collapse_homogeneous(sp_agg)
    check_axes_unambiguous(sp_agg, *Xm.shape, "sp")
    orders, sp_p, Xp, Wp = hetero_order_batch(sp_agg, Xm, Wm, m, B)
    sched = plan_sharded(sp_p, Xp, Wp, B=B, active=active, mesh=mesh,
                         chunk_size=chunk_size, **kwargs)
    return np.take_along_axis(perm, orders, axis=1), sched


# ---------------------------------------------------------------------------
# Sharded ensemble simulation
# ---------------------------------------------------------------------------

def simulate_ensemble_sharded(
    sp,
    policies,
    X,
    W,
    arrival=None,
    B=None,
    rtol: float = 1e-12,
    n_events: int | None = None,
    faults=None,
    *,
    mesh: FleetMesh | None = None,
    chunk_size: int | None = None,
) -> EnsembleResult:
    """``simulate_ensemble`` with the workload axis sharded over a mesh.

    Same contract as ``simulate_ensemble`` (see ``core/simulator.py``) —
    P policies × K workloads, per-workload sp/policy leaves batch by the
    leading-dim-K convention and shard alongside their workloads.
    Policies stay a Python loop; workloads partition over ``mesh`` with
    chunked streaming as in ``plan_sharded``.

    ``faults``: optional ``FaultTrace`` (1-D shared, or (K, S) — one
    trace per workload).  Fault arrays broadcast to (K, S+1) and shard
    *alongside their workloads*; padded instances (edge-replicated
    traces, no live jobs) halt before consuming any fault, and every
    policy needs a ``B`` leaf to seed its budget carry.  The result
    lives on the mesh's first device.
    """
    mesh = _resolve_mesh(mesh, X, sp)
    home = mesh.devices.flat[0]
    X = as_tensor(X, home)
    W = as_tensor(W, home, X.dtype)
    if X.ndim != 2 or W.shape != X.shape:
        raise ValueError("X and W must both be (K, M)")
    K, M = X.shape
    _validate_workload(X, W, arrival, what="simulate_ensemble_sharded")
    _validate_budget(B, "simulate_ensemble_sharded")
    ARR = (torch.zeros_like(X) if arrival is None
           else as_tensor(arrival, home, X.dtype))
    if ARR.shape != X.shape:
        raise ValueError("arrival must be (K, M)")
    policies = tuple(policies)
    if not policies:
        raise ValueError("need at least one policy")
    names = tuple(getattr(p, "name", type(p).__name__) for p in policies)
    if M == 0:
        Pn = len(policies)
        return EnsembleResult(
            J=torch.zeros((Pn, K), dtype=X.dtype, device=home),
            T=torch.zeros((Pn, K, 0), dtype=X.dtype, device=home),
            finished=torch.ones((Pn, K), dtype=torch.bool, device=home),
            n_events=torch.zeros((Pn, K), dtype=torch.int64, device=home),
            exhausted=torch.zeros((Pn, K), dtype=torch.bool, device=home),
            policy_names=names)
    check_axes_unambiguous(sp, K, M, "sp")
    for p in policies:
        if not getattr(p, "device_ready", False):
            raise ValueError(
                f"policy {p!r} is not device-ready; use sched/policies.py")
        _check_policy_budget(p, B)
        _validate_budget(getattr(p, "B", None), "simulate_ensemble_sharded",
                         source=f"policy {getattr(p, 'name', p)!r}.B")
        check_axes_unambiguous(p, K, M, f"policy {getattr(p, 'name', p)!r}")
    flt = None
    if faults is not None:
        for p in policies:
            _fault_B0(p, None, "simulate_ensemble_sharded")
        flt = _prepared_faults(faults, M, K, X)
        n_events = int(n_events or _fault_n_events(M, faults.S))
    else:
        n_events = int(n_events or n_events_for(M))

    D = mesh.size
    total, _, _ = _chunk_layout(K, D, chunk_size)
    sp = map_leaves(sp, lambda l: l.to(device=home, dtype=X.dtype))
    sp_split = _SplitLeaves(sp, K)
    sp_pad = sp_split.map(sp, lambda l: _pad_rows(l, total, edge=True))
    Xp = _pad_rows(X, total, edge=False)     # size-0 jobs: inert instance
    Wp = _pad_rows(W, total, edge=False)
    ARRp = _pad_rows(ARR, total, edge=False)
    if flt is not None:
        # edge-replicated rows stay valid sorted traces; padded instances
        # have no live jobs, so the engine halts before consuming them
        flt = tuple(_pad_rows(l, total, edge=True) for l in flt)

    Js, Ts, fins, nev = [], [], [], []
    for pol in policies:
        pb = _bound(pol, home, X.dtype)
        pol_split = _SplitLeaves(pb, K)
        pb_pad = pol_split.map(pb, lambda l: _pad_rows(l, total, edge=True))

        def one(lo, hi, dev, pb_pad=pb_pad, pol_split=pol_split):
            maps = _rows(lo, hi, dev, M)
            spv = sp_split.map(sp_pad, *maps)
            pv = _bound(pol_split.map(pb_pad, *maps), dev, X.dtype)
            x = Xp[lo:hi].to(dev)
            w = Wp[lo:hi].to(dev)
            f = None if flt is None else tuple(l[lo:hi].to(dev) for l in flt)
            T, finished, ne, _ = _sim_core(
                spv, pv, x, w, ARRp[lo:hi].to(dev), rtol, n_events,
                faults=f, B0=None if f is None else pv.B)
            return T, _objective(w, T, finished), finished, ne

        T, J, finished, ne = _run_sharded(mesh, one, K, chunk_size)
        Ts.append(T)
        Js.append(J)
        fins.append(finished)
        nev.append(ne)
    finished_all = torch.stack(fins)
    nev_all = torch.stack(nev)
    exhausted = (~finished_all) & (nev_all >= n_events)
    _warn_event_budget(exhausted, n_events, "simulate_ensemble_sharded")
    return EnsembleResult(J=torch.stack(Js), T=torch.stack(Ts),
                          finished=finished_all, n_events=nev_all,
                          exhausted=exhausted, policy_names=names)


# ---------------------------------------------------------------------------
# Sharded multi-tenant streaming service
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FleetStreamResult:
    """T tenant streams serviced on the mesh, plus the cross-tenant view.

    ``results[i]`` is tenant i's full ``StreamResult`` (identical in
    meaning to a solo ``StreamController.run_device``).  The remaining
    fields are the fleet-level admission view — the summary a host
    admission/budget controller reads *across* tenants at the horizon:

      backlog: (T,) jobs still unfinished (live slots + FIFO queue).
      unfinished_work: (T,) remaining size mass (partial progress of
        live jobs counted, queued jobs at full size).
      mean_slowdown / p99_latency / deadline_misses: (T,) per-tenant
        SLO columns lifted out of the per-tenant metrics.
      suggested_budget_share: (T,) sums to 1 — unfinished work,
        normalized; the proportional-fair advisory split of the next
        planning round's global budget (uniform when the fleet drained).
    """

    results: tuple
    backlog: np.ndarray
    unfinished_work: np.ndarray
    mean_slowdown: np.ndarray
    p99_latency: np.ndarray
    deadline_misses: np.ndarray
    suggested_budget_share: np.ndarray

    def __len__(self) -> int:
        return len(self.results)


# the carry's entries a tenant's service returns: the fleet view's and
# the counters ``_finalize`` reads
_SERVE_KEYS = ("completion", "rem", "active", "qbuf", "qhead", "qtail",
               "replans", "warm_ct", "cold_ct", "degraded", "n_windows")


def _serve_fn(sp, events, X, W, budgets, M: int, plan_latency: float,
              rtol: float, cert_rtol: float, knobs: dict):
    """The per-device body of ``serve_streams_sharded``: ``fn(lo, hi,
    dev)`` services the padded tenant rows lo..hi on ``dev``.

    Tenants run one after another, each a whole event loop over its own
    carry — never batched: a batched carry would have to take both sides
    of every branch (the cascade's solve and search, the ladder, the cut
    re-run) for every tenant at every event, inert ones included.  A
    padded tenant carries only kind-0 events, which its loop skips.
    """
    from ..robust.degrade import DegradingPolicy
    from ..serve.stream import _Loop, _stream_chunk, _stream_state0

    Nmax = X.shape[1]

    def fn(lo, hi, dev):
        sp_d = _on(sp, dev, torch.float64)
        outs = []
        for i in range(lo, hi):
            b = float(budgets[i])
            loop = _Loop(sp=sp_d, ladder=DegradingPolicy.ladder(sp_d, B=b),
                         x_all=X[i].to(dev), w_all=W[i].to(dev), B_key=b,
                         plan_latency=plan_latency, rtol=rtol,
                         cert_rtol=cert_rtol, knobs=knobs)
            st = _stream_state0(M, Nmax, b, torch.float64, dev)
            st = _stream_chunk(st, tuple(a[i] for a in events), loop)
            outs.append(st)
        return tuple(torch.stack([st[k] for st in outs])
                     for k in _SERVE_KEYS)

    return fn


def serve_streams_sharded(
    sp,
    streams,
    *,
    budgets=None,
    max_live: int = 16,
    mesh: FleetMesh | None = None,
    chunk_size: int | None = None,
    plan_latency: float = 0.0,
    rtol: float = 1e-12,
    certificate_rtol: float = 1e-8,
    coarse: int = 32,
    descent_iters: int = 40,
    cap_iters: int = 64,
    stol_rel: float | None = None,
    search_steps: int | None = None,
) -> FleetStreamResult:
    """T independent tenant streams serviced on device, tenant axis
    sharded over the mesh.

    Each tenant is one ``ArrivalStream`` driven through the same event
    loop as ``StreamController.run_device`` — cascade replanning,
    double-buffered plans, FIFO queue, cut-at-first-completion backfill
    — under its own nominal budget (trace budget events still override
    live).  Tenants are independent streams, so the devices exchange
    nothing and tenant i's result is bit-identical to a solo
    ``run_device`` of the same stream (``tests/test_torch_fleet_stream.py``
    pins it).  Within a device its tenants run one after another.

    Padding reuses the fleet contract: tenant rows pad to the mesh
    multiple with zeros, and the event encoding makes an all-zero row
    *inert* (kind 0 = pad event, skipped), so a padded tenant costs one
    skipped loop; event and job axes pad to the fleet maxima the same
    way.  The speedup is shared fleet-wide (one scalar-leaf speedup;
    per-tenant speedups belong in separate fleets); ``budgets`` is the
    per-tenant nominal budget vector (default: ``sp.B`` for every
    tenant), which also seeds each tenant's ladder fallback.  Runs in
    float64 on the mesh (default: the active mesh context, else one
    device: the speedup's, CUDA by default).

    Returns a ``FleetStreamResult``: per-tenant ``StreamResult``s plus
    the cross-tenant admission view (backlog, unfinished work, SLO
    columns, and the advisory ``suggested_budget_share``).
    """
    from ..serve.stream import StreamController, _event_arrays

    streams = tuple(streams)
    T = len(streams)
    if T < 1:
        raise ValueError("need at least one tenant stream")
    sp = collapse_homogeneous(sp)
    if is_per_job(sp):
        raise ValueError(
            "serve_streams_sharded needs one shared scalar-leaf speedup; "
            "per-tenant speedups belong in separate fleets")
    M = int(max_live)
    if M < 1:
        raise ValueError("max_live must be >= 1")
    if budgets is None:
        budgets = [float(sp.B)] * T
    budgets = [float(b) for b in budgets]
    if len(budgets) != T:
        raise ValueError("budgets must give one nominal budget per tenant")

    Ns = [len(s) for s in streams]
    Nmax = max(1, max(Ns))
    evs = [_event_arrays(s) for s in streams]
    Emax = max(e[0].size for e in evs)
    t_e = np.zeros((T, Emax))
    kind = np.zeros((T, Emax), np.int32)
    pi = np.zeros((T, Emax), np.int32)
    pf = np.zeros((T, Emax))
    for i, (te, kd, pj, pv) in enumerate(evs):
        t_e[i, :te.size] = te
        kind[i, :te.size] = kd
        pi[i, :te.size] = pj
        pf[i, :te.size] = pv
    X = np.zeros((T, Nmax))
    W = np.zeros((T, Nmax))
    for i, strm in enumerate(streams):
        X[i, :Ns[i]] = np.asarray(strm.x, float)
        W[i, :Ns[i]] = np.asarray(strm.w, float)

    mesh = _resolve_mesh(mesh, sp)
    home = mesh.devices.flat[0]
    total, _, _ = _chunk_layout(T, mesh.size, chunk_size)
    # host-side rows: a tenant's events and budget are read by its loop
    events = tuple(_pad_rows(torch.from_numpy(a), total, edge=False).numpy()
                   for a in (t_e, kind, pi, pf))
    Bp = _pad_rows(torch.tensor(budgets, dtype=torch.float64), total,
                   edge=True).tolist()
    Xp = _pad_rows(torch.from_numpy(X), total, edge=False)
    Wp = _pad_rows(torch.from_numpy(W), total, edge=False)
    sp = _on(sp, home, torch.float64)
    knobs = dict(fast=_fast_ok(sp), coarse=int(coarse),
                 descent_iters=int(descent_iters), cap_iters=int(cap_iters),
                 stol_rel=stol_rel,
                 search_steps=4 * M if search_steps is None
                 else int(search_steps))
    fn = _serve_fn(sp, events, Xp, Wp, Bp, M, float(plan_latency),
                   float(rtol), float(certificate_rtol), knobs)
    out = dict(zip(_SERVE_KEYS, (o.cpu().numpy() for o in
                                 _run_sharded(mesh, fn, T, chunk_size))))

    comp_all = out["completion"].astype(float)
    rem = out["rem"].astype(float)
    act = out["active"].astype(bool)
    qb, qh, qt = out["qbuf"], out["qhead"], out["qtail"]
    results = []
    backlog = np.zeros(T, int)
    work = np.zeros(T)
    for i, strm in enumerate(streams):
        ctl = StreamController(sp, budgets[i], max_live=M,
                               plan_latency=plan_latency, rtol=rtol,
                               device=home)
        results.append(ctl._finalize(
            strm, comp_all[i, :Ns[i]], np.ones(Ns[i], bool),
            replans=int(out["replans"][i]),
            warm_replans=int(out["warm_ct"][i]),
            cold_replans=int(out["cold_ct"][i]),
            degraded=int(out["degraded"][i]),
            n_windows=int(out["n_windows"][i])))
        qidx = qb[i, qh[i]:qt[i]]
        backlog[i] = int(act[i].sum()) + qidx.size
        work[i] = float(np.sum(rem[i] * act[i]))
        if qidx.size:
            work[i] += float(np.sum(np.asarray(strm.x, float)[qidx]))
    share = (work / work.sum() if work.sum() > 0
             else np.full(T, 1.0 / T))
    return FleetStreamResult(
        results=tuple(results),
        backlog=backlog,
        unfinished_work=work,
        mean_slowdown=np.array([r.metrics.mean_slowdown for r in results]),
        p99_latency=np.array([r.metrics.p99_latency for r in results]),
        deadline_misses=np.array([r.metrics.deadline_misses
                                  for r in results]),
        suggested_budget_share=share,
    )
