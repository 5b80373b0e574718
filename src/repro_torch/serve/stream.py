"""Streaming control plane: open-arrival online service.

The scenario engine simulates *closed* instances on a fixed event
horizon (4M+16); a production service faces an unbounded arrival
stream.  ``StreamController`` services one (``core.workloads.
ArrivalStream``) as a host-driven loop over **arrival windows** — the
spans between consecutive control-plane events (arrivals, budget steps,
end of trace) — with carried state: remaining sizes, the live slot
mask, the live budget B(t), and the planner's warm-start payload
(completion order + λ-bracket).

Inside a window nothing changes that the plan did not anticipate, so
execution is one fixed-shape loop of device operations
(``_exec_window``): each step looks up the active-count column of the
current plan table, advances to the earlier of the next completion and
the window end, and retires completed rows — at most M completions plus
a final advance, so M+1 steps regardless of the window length, and no
host read inside.  The host loop between windows is the control plane
proper:

  * **Warm-started replanning** — every event hands the live state to a
    ``StreamingSmartFillPolicy``, which reuses the previous plan's
    completion order and λ payload and falls back to a cold solve when
    the bracket-validation probe or the J == J_linear certificate
    fails (see ``sched.policies``).

  * **Double-buffered plans** (``PlanBuffer``) — the executor always
    reads the *front* plan; a freshly solved plan is published to the
    back buffer with the solve's latency and promoted at the first
    window boundary past its ready time.  Admission therefore never
    blocks on an in-flight solve: the stream keeps executing the stale
    front plan (allocations stay feasible — the table is
    active-count-indexed), and jobs admitted meanwhile simply idle
    until the next plan covers them.

  * **Certified degradation** — a replan that fails certification (or
    raises) does not reach the executor: the controller counts a
    degraded window and swaps in a ``robust.ladder_plan_table`` built
    from the degradation ladder (SmartFill → GWF-static → EQUI, each
    column certificate-gated): solver failures are absorbed, never
    executed.

  * **Watchdog-wrapped admission** — an optional ``AdmissionController``
    (which must run in ``agreeable="rank"`` mode: live half-served
    state is non-agreeable by construction) scores each arrival's
    marginal ΔJ against the live set; its watchdog degrades to
    deny-all rather than stalling the loop.

``StreamController.run_device`` services the same trace with the whole
control-plane state on the device (see the section below): the host
only takes the branches, reading a few device flags an event.

SLO metrics follow the heSRPT-slowdown line of work (Berg et al.,
arXiv:1903.09346; slowdown variant arXiv:2011.09676): alongside the
paper's weighted J (= weighted flow time here) the result reports mean
slowdown (flow time over the job's hypothetical solo service time
x/s(B)), p50/p99 latency, and deadline misses.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import as_tensor, resolve_device
from ..core.smartfill import WarmStart, _fast_ok, _on
from ..core.speedup import Speedup, collapse_homogeneous, is_per_job
from ..core.workloads import ArrivalStream
from ..robust.degrade import DegradingPolicy, ladder_plan_table
from ..sched.policies import (HostReads, StreamCascadePolicy,
                              StreamingSmartFillPolicy, StreamPlan,
                              stream_replan_core, stream_warm0)

__all__ = ["StreamMetrics", "StreamResult", "PlanBuffer",
           "StreamController", "StreamCascadePolicy"]


# ---------------------------------------------------------------------------
# Window executor: one fixed-length loop of device operations per window
# ---------------------------------------------------------------------------

def _rate_floor(dtype) -> float:
    """Smallest admissible completion-rate denominator for ``dtype``.

    A literal floor of ``1e-300`` is fine in float64 but *flushes to
    zero* in float32 (``np.float32(1e-300) == 0.0``), leaving the
    division unprotected exactly where it matters: a live row whose
    rate lands in the float32 denormal range divides by a denormal and
    the step width goes inf.  tiny/eps is the smallest normal-scaled
    floor (≈9.9e-32 in float32, ≈1e-292 in float64), far below any
    physical rate, so dt stays finite without perturbing healthy
    windows.
    """
    fi = torch.finfo(dtype)
    return fi.tiny / fi.eps


def _exec_window(sp, table, rem0, live0, span, rtol):
    """Advance the live rows ``span`` time under ``table`` (row coords).

    A fixed loop of M+1 steps (at most M completions plus one final
    advance; exhausted windows step with h = 0), all device operations,
    no host read.  Each step:

      * the live count m selects column m−1 of the plan table, whose
        first m entries are assigned to the live rows *by rank* — for a
        prefix live set (the normal case: completions retire the last
        row first) this is the identity, and for the non-prefix sets a
        stale double-buffered plan can produce it degrades gracefully
        (rank r reads the allocation planned for rank r);
      * rates are s(θ) under the (shared) server speedup, the step
        advances to min(next completion, window end), and rows whose
        remaining size falls below the completion tolerance retire.

    ``table`` (M, M), ``rem0`` (M,) and ``live0`` (M,) are tensors on one
    device in one dtype; ``span`` a float or a 0-d tensor.  Returns
    ``(rem_end, live_end, comp)`` with ``comp[i]`` the completion offset
    from the window start (+inf where row i survived).
    """
    M = rem0.shape[0]
    dtype, dev = rem0.dtype, rem0.device
    eps = torch.finfo(dtype).eps
    tol = (max(float(rtol), 8.0 * eps)
           * torch.clamp_min(torch.max(rem0), 1.0))
    floor = _rate_floor(dtype)
    # every entry's rate once: s is elementwise, so an entry's rate is
    # the one s gives that allocation alone
    rates = sp.s(table)
    rem, live = rem0, live0
    left = (span.to(dtype) if isinstance(span, torch.Tensor)
            else torch.full((), span, dtype=dtype, device=dev))
    elapsed = torch.zeros((), dtype=dtype, device=dev)
    comp = torch.full((M,), torch.inf, dtype=dtype, device=dev)
    for _ in range(M + 1):
        col = torch.clamp(live.sum() - 1, 0, M - 1).reshape(1)
        rank = torch.clamp(torch.cumsum(live, 0) - 1, 0, M - 1)
        rate = torch.where(live, rates[rank, col], 0.0)
        dt = torch.where(live & (rate > 0),
                         rem / torch.clamp_min(rate, floor), torch.inf)
        h = torch.clamp_min(torch.minimum(torch.min(dt), left), 0.0)
        rem2 = torch.where(live, torch.clamp_min(rem - rate * h, 0.0), rem)
        done = live & (rem2 <= tol)
        elapsed = elapsed + h
        comp = torch.where(done, elapsed, comp)
        rem = torch.where(done, 0.0, rem2)
        live = live & ~done
        left = left - h
    return rem, live, comp


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StreamMetrics:
    """SLO summary of one stream run (completed jobs only, except the
    deadline counters, which charge unfinished past-deadline jobs too)."""

    n_arrivals: int
    n_admitted: int
    n_rejected: int
    n_completed: int
    weighted_J: float          # Σ w_i (C_i − a_i): weighted flow time
    mean_flow: float
    mean_slowdown: float       # (C_i − a_i) / (x_i / s(B)), averaged
    p50_latency: float
    p99_latency: float
    deadline_misses: int
    deadline_total: int


@dataclasses.dataclass(frozen=True)
class StreamResult:
    """Full outcome of ``StreamController.run`` (host-materialized).

    Per-job arrays are stream-indexed (length N = len(stream));
    ``completion`` is +inf for jobs still live (or rejected) at the
    horizon.  ``replans``/``warm_replans``/``cold_replans`` count
    planner invocations; ``degraded_windows`` counts windows executed
    on the ladder fallback table; ``n_events`` counts control-plane
    events (windows), not engine steps.
    """

    metrics: StreamMetrics
    completion: np.ndarray
    latency: np.ndarray
    slowdown: np.ndarray
    admitted: np.ndarray
    replans: int
    warm_replans: int
    cold_replans: int
    degraded_windows: int
    n_events: int


# ---------------------------------------------------------------------------
# Double-buffered plans
# ---------------------------------------------------------------------------

class PlanBuffer:
    """Front/back plan pair: the executor reads ``front``; ``publish``
    stages a new plan behind a ready time, ``poll`` promotes it once the
    stream clock passes that time.  This models the in-flight solve of
    a real control plane in a single-threaded loop: admission and
    execution proceed against the stale front plan while the "solver"
    (ready-time delay) runs — they never block on it.  Promotion
    happens at window boundaries (the executor holds one table per
    window by construction)."""

    def __init__(self):
        self.front: StreamPlan | None = None
        self.back: tuple[float, StreamPlan] | None = None
        self.swaps = 0

    def publish(self, plan: StreamPlan, ready_at: float = -np.inf) -> None:
        self.back = (float(ready_at), plan)

    def poll(self, now: float) -> StreamPlan | None:
        if self.back is not None and now >= self.back[0]:
            self.front = self.back[1]
            self.back = None
            self.swaps += 1
        return self.front


# ---------------------------------------------------------------------------
# The controller
# ---------------------------------------------------------------------------

class StreamController:
    """Online service loop over an ``ArrivalStream`` (module docstring).

    Args:
      sp: *shared* server speedup (job-indexed leaves are rejected —
        slots are reused across jobs, so per-slot leaves would silently
        reassign speedups; per-job heterogeneous replanning is
        ``StreamingSmartFillPolicy``'s direct API).
      B: nominal budget (defaults to sp.B); budget events in the trace
        override it live.
      max_live: slot capacity M — the padded width every replanning
        solve and window execution runs at.  Arrivals beyond capacity
        queue FIFO.
      policy: the incremental re-planner; defaults to a
        ``StreamingSmartFillPolicy(sp, B)``.
      admission: optional ``AdmissionController`` in ``agreeable="rank"``
        mode; scores every arrival against the live set, deny ⇒ the job
        is rejected (never queued).  Its watchdog semantics apply.
      ladder: certificate-gated fallback for failed replans; defaults to
        the canonical ``DegradingPolicy.ladder(sp, B)``.
      plan_latency: simulated solve latency — a replanned table becomes
        visible to the executor only ``plan_latency`` after its event
        (double buffering; 0 ⇒ plans land instantly).
      rtol: completion tolerance of the window executor.
      device: where the windows, the replans and the device event loop
        run (default: the device of ``sp``'s leaves, else CUDA), in
        float64.
    """

    def __init__(self, sp: Speedup, B: float | None = None, *,
                 max_live: int = 16,
                 policy: StreamingSmartFillPolicy | None = None,
                 admission=None, ladder: DegradingPolicy | None = None,
                 plan_latency: float = 0.0, rtol: float = 1e-12,
                 device=None):
        self.device = resolve_device(device, sp)
        sp = collapse_homogeneous(_on(sp, self.device, torch.float64))
        if is_per_job(sp):
            raise ValueError(
                "StreamController needs a shared speedup; per-job "
                "streams replan through StreamingSmartFillPolicy "
                "directly")
        self.sp = sp
        self.B = float(sp.B if B is None else B)
        self.M = int(max_live)
        if self.M < 1:
            raise ValueError("max_live must be >= 1")
        self.policy = (StreamingSmartFillPolicy(sp, self.B,
                                                device=self.device)
                       if policy is None else policy)
        if admission is not None and admission.agreeable != "rank":
            raise ValueError(
                "stream admission must use agreeable='rank': live "
                "half-served state is non-agreeable by construction")
        self.admission = admission
        self.ladder = (DegradingPolicy.ladder(sp, B=self.B)
                       if ladder is None else ladder)
        self.plan_latency = float(plan_latency)
        self.rtol = float(rtol)
        self.host_reads = 0       # device flags read by the last run_device

    # -- internals --------------------------------------------------------

    def _admit(self, xj, wj, rem, wslot, active) -> bool:
        """Score one arrival against the live set (deny ⇒ reject)."""
        if self.admission is None:
            return True
        dec = self.admission.evaluate(
            rem[active], wslot[active], np.asarray([xj]), np.asarray([wj]))
        # watchdog exhaustion fails closed (deny-all, status degraded)
        return bool(dec.admit[0])

    def _replan(self, t, rem, w, active, B_live, buffer) -> tuple[int, int]:
        """Solve on the live state; publish certified plans, fall down
        the ladder otherwise.  Returns (degraded, replanned) counts."""
        try:
            plan = self.policy.plan(rem, w, active, B=B_live)
            failed = not plan.certified
        except (FloatingPointError, ValueError, RuntimeError):
            plan, failed = None, True
        if not failed:
            buffer.publish(plan, ready_at=t + self.plan_latency)
            return 0, 1
        # ladder fallback: certificate-gated columns on the *current*
        # SJF ranking — published instantly (the emergency plan must
        # not sit behind a solve latency)
        order = np.where(active)[0][np.argsort(-rem[active], kind="stable")]
        m = order.size
        rem_rows = np.zeros(self.M)
        w_rows = np.zeros(self.M)
        rem_rows[:m] = rem[order]
        w_rows[:m] = w[order]
        table = ladder_plan_table(self.ladder, rem_rows, w_rows, B=B_live,
                                  device=self.device)
        buffer.publish(StreamPlan(
            order=order, table=table, J=float("nan"), J_linear=float("nan"),
            m=m, B=B_live, warm=False, certified=False))
        return 1, 1

    def _execute(self, plan, t0, t1, rem, w, active, job_of_slot,
                 completion, cut_after_completion=False) -> float:
        """Run [t0, t1) under ``plan``; mutate slot state in place.

        With ``cut_after_completion`` the segment stops at the first
        completion instead of running to t1 (the controller uses this
        when jobs are queued: a freed slot must be backfilled and
        replanned *at the completion time*, not at the next event).
        Returns the time actually reached (t1, or the cut time).
        """
        M = self.M
        dev = self.device
        order = np.asarray(plan.order, np.int64)
        k = order.size
        rows = np.full(M, -1, np.int64)
        rows[:k] = order
        live = np.zeros(M, bool)
        live[:k] = active[order] & (rem[order] > 0)
        rem_rows = np.zeros(M)
        rem_rows[:k] = rem[order]
        table = as_tensor(plan.table, dev, torch.float64)
        rem_t = as_tensor(rem_rows, dev)
        live_t = as_tensor(live, dev)
        rem_end, live_end, comp = _exec_window(
            self.sp, table, rem_t, live_t, t1 - t0, self.rtol)
        comp = comp.cpu().numpy()
        t_end = t1
        if cut_after_completion and np.isfinite(comp).any():
            c0 = float(np.min(comp[np.isfinite(comp)]))
            if t0 + c0 < t1:
                t_end = t0 + c0
                rem_end, live_end, comp = _exec_window(
                    self.sp, table, rem_t, live_t, c0, self.rtol)
                comp = comp.cpu().numpy()
        rem_end = rem_end.cpu().numpy()
        freed = []
        for r in range(k):
            s = rows[r]
            if not live[r]:
                continue
            rem[s] = rem_end[r]
            if np.isfinite(comp[r]):
                completion[job_of_slot[s]] = t0 + comp[r]
                active[s] = False
                job_of_slot[s] = -1
                rem[s] = 0.0
                freed.append(s)
        if freed:
            # drop the freed slots from the planner's carried order NOW:
            # a queued job may recycle the slot before the next replan,
            # and it must enter the order as an arrival, not inherit the
            # completed job's position
            self.policy.release(np.asarray(freed))
        return t_end

    # -- interface --------------------------------------------------------

    def run(self, stream: ArrivalStream) -> StreamResult:
        """Service the whole trace; see the module docstring."""
        N = len(stream)
        M = self.M
        x_all = np.asarray(stream.x, float)
        w_all = np.asarray(stream.w, float)
        t_all = np.asarray(stream.t, float)

        # merged control-plane events: (time, kind, payload), stable in
        # time with arrivals before budget steps at ties
        events = [(t_all[j], 0, j) for j in range(N)]
        events += [(float(bt), 1, float(bv)) for bt, bv in
                   zip(stream.budget_times, stream.budget_values)]
        events.sort(key=lambda e: (e[0], e[1]))
        events.append((float(stream.horizon), 2, 0.0))

        rem = np.zeros(M)
        wslot = np.zeros(M)
        active = np.zeros(M, bool)
        job_of_slot = np.full(M, -1, np.int64)
        completion = np.full(N, np.inf)
        admitted = np.zeros(N, bool)
        queue: list[int] = []

        buffer = PlanBuffer()
        self.policy.reset()
        B_live = self.B
        t_prev = 0.0
        degraded = 0
        replans = 0
        n_windows = 0

        def fill_free_slots() -> bool:
            """Queued jobs into free slots (FIFO); True if any landed."""
            landed = False
            while queue and not active.all():
                j = queue.pop(0)
                s = int(np.flatnonzero(~active)[0])
                rem[s] = x_all[j]
                wslot[s] = w_all[j]
                active[s] = True
                job_of_slot[s] = j
                landed = True
            return landed

        for t_ev, kind, payload in events:
            # 1. execute up to this event on the front plan, splitting
            # the window (a) where a back-buffered plan comes ready, so
            # an in-flight solve lands mid-window instead of waiting for
            # the next control-plane event, and (b) at completions while
            # jobs are queued, so freed slots backfill at the completion
            # time rather than idling until the next arrival
            t_cur = t_prev
            while t_cur < t_ev:
                plan = buffer.poll(t_cur)
                t_stop = t_ev
                if buffer.back is not None and buffer.back[0] < t_ev:
                    t_stop = buffer.back[0]   # > t_cur: poll() promoted
                if plan is None or not active.any():
                    t_cur = t_stop
                    continue
                t_end = self._execute(plan, t_cur, t_stop, rem, wslot,
                                      active, job_of_slot, completion,
                                      cut_after_completion=bool(queue))
                n_windows += 1
                if t_end < t_stop and fill_free_slots():
                    d, r = self._replan(t_end, rem, wslot, active,
                                        B_live, buffer)
                    degraded += d
                    replans += r
                t_cur = t_end
            buffer.poll(t_ev)
            changed = fill_free_slots()
            # 2. apply the event
            if kind == 0:
                j = int(payload)
                if self._admit(x_all[j], w_all[j], rem, wslot, active):
                    admitted[j] = True
                    queue.append(j)
                    changed = fill_free_slots() or True
            elif kind == 1:
                changed = True
                B_live = float(payload)
            else:                                   # end of trace
                break
            # 3. replan on the new state (double-buffered)
            if changed or buffer.front is None:
                d, r = self._replan(t_ev, rem, wslot, active, B_live,
                                    buffer)
                degraded += d
                replans += r
            t_prev = t_ev

        return self._finalize(stream, completion, admitted,
                              replans=replans,
                              warm_replans=self.policy.warm_replans,
                              cold_replans=self.policy.cold_replans,
                              degraded=degraded, n_windows=n_windows)

    def _finalize(self, stream, completion, admitted, *, replans,
                  warm_replans, cold_replans, degraded,
                  n_windows) -> StreamResult:
        """SLO metrics from a completion array — shared verbatim by the
        host loop and the device loop so the two paths are compared on
        identical formulas."""
        N = len(stream)
        x_all = np.asarray(stream.x, float)
        w_all = np.asarray(stream.w, float)
        t_all = np.asarray(stream.t, float)
        lat = completion - t_all
        s_B = float(self.sp.s(torch.full((), self.B, dtype=torch.float64,
                                          device=self.device)))
        solo = x_all / max(s_B, 1e-300)
        slow = lat / np.maximum(solo, 1e-300)
        done = np.isfinite(completion)
        fin = lat[done]
        dl = np.asarray(stream.deadline, float)
        has_dl = np.isfinite(dl) & admitted
        misses = int(np.sum(has_dl & (completion > dl)))
        metrics = StreamMetrics(
            n_arrivals=N,
            n_admitted=int(admitted.sum()),
            n_rejected=int(N - admitted.sum()),
            n_completed=int(done.sum()),
            weighted_J=float(np.sum(w_all[done] * fin)),
            mean_flow=float(fin.mean()) if fin.size else 0.0,
            mean_slowdown=float(slow[done].mean()) if fin.size else 0.0,
            p50_latency=float(np.percentile(fin, 50)) if fin.size else 0.0,
            p99_latency=float(np.percentile(fin, 99)) if fin.size else 0.0,
            deadline_misses=misses,
            deadline_total=int(has_dl.sum()),
        )
        return StreamResult(
            metrics=metrics, completion=completion, latency=lat,
            slowdown=slow, admitted=admitted, replans=replans,
            warm_replans=warm_replans, cold_replans=cold_replans,
            degraded_windows=degraded, n_events=n_windows)

    def _knobs(self) -> dict:
        """The cascade's knobs, read off ``self.policy`` when present so
        an oracle/device pair is configured once."""
        p = self.policy
        return dict(
            cert_rtol=float(getattr(p, "certificate_rtol", 1e-8)),
            coarse=int(getattr(p, "coarse", 32)),
            descent_iters=int(getattr(p, "descent_iters", 40)),
            cap_iters=int(getattr(p, "cap_iters", 64)),
            stol_rel=getattr(p, "stol_rel", None),
            search_steps=(4 * self.M
                          if getattr(p, "search_steps", None) is None
                          else int(p.search_steps)),
            fast=_fast_ok(self.sp),
        )

    def run_device(self, stream: ArrivalStream, *,
                   chunk_events: int | None = None) -> StreamResult:
        """Service the whole trace with the control-plane state on the
        device: the slot state, the FIFO queue, the ``PlanBuffer``
        front/back pair and the ``WarmStart`` payload live in a dict of
        tensors (``_stream_state0``), and one event is one
        ``_stream_event`` over it.

        Same contract as ``run`` modulo the replanning policy: the
        device loop replans through the ``stream_replan_core`` cascade
        (fresh hinted solve → certificate → exchange search → ladder,
        each a real branch), so ``StreamController.run`` with a
        ``StreamCascadePolicy`` makes the *same* decisions through the
        host loop and is this path's differential oracle, bit for bit.
        The host takes the branches by reading device flags (counted in
        ``self.host_reads``); events are serviced in chunks of
        ``chunk_events`` (default: the whole trace in one), the carry
        crossing the chunk boundaries unchanged.

        Admission must be None (device arrivals are all admitted) —
        scoring arrivals against the live set is host control-plane
        logic.  Cascade knobs (certificate rtol, solver sizes, search
        budget) are read off ``self.policy`` when present.
        """
        if self.admission is not None:
            raise ValueError(
                "run_device supports admission=None only; scored "
                "admission stays on the host loop")
        N = len(stream)
        M = self.M
        dev = self.device
        knobs = self._knobs()
        cert_rtol = knobs.pop("cert_rtol")
        events = _event_arrays(stream)
        E = events[0].size
        W = E if chunk_events is None else max(int(chunk_events), 1)
        loop = _Loop(sp=self.sp, ladder=self.ladder,
                     x_all=as_tensor(np.asarray(stream.x, float), dev),
                     w_all=as_tensor(np.asarray(stream.w, float), dev),
                     B_key=self.B, plan_latency=self.plan_latency,
                     rtol=self.rtol, cert_rtol=cert_rtol, knobs=knobs)
        state = _stream_state0(M, N, self.B, torch.float64, dev)
        for lo in range(0, E, W):
            state = _stream_chunk(state, tuple(a[lo:lo + W] for a in events),
                                  loop)
        self.host_reads = loop.read.n
        completion = state["completion"][:N].cpu().numpy()
        admitted = np.ones(N, bool)
        counts = _counters(state)
        return self._finalize(
            stream, completion, admitted,
            replans=counts["replans"],
            warm_replans=counts["warm_ct"],
            cold_replans=counts["cold_ct"],
            degraded=counts["degraded"],
            n_windows=counts["n_windows"])


# ---------------------------------------------------------------------------
# Device-resident event loop
# ---------------------------------------------------------------------------
#
# The host loop above is the differential oracle; everything below is
# the same control plane over a carry of device tensors.  Event kinds
# are encoded so an all-zero row is *inert* — the fleet driver's padding
# contract (distributed/fleet.py) then works unchanged for padded
# tenants:
#
#   0 = pad (no-op), 1 = arrival (pi = job index), 2 = budget step
#   (pf = new budget), 3 = end of trace.
#
# One event: execute up to the event on the front plan (splitting
# windows where a back-buffered plan comes ready and at completions
# while jobs are queued — the cut at the first completion re-runs the
# same `_exec_window` the host calls), then apply the event and replan
# through the cascade.  The event kinds are host data; every other
# branch (the window loop, the cut and its backfill, the queue's
# landings, the cascade's search and ladder) reads its device flags on
# the host and runs one side, never both.  Cheap selections (`_promote`,
# the budget) stay `torch.where` masks.

_COUNTERS = ("n_windows", "replans", "degraded", "warm_ct", "cold_ct",
             "searches")


@dataclasses.dataclass
class _Loop:
    """What every event of one stream's device loop shares: the server
    speedup, the ladder, the stream's job sizes and weights on the
    device, the nominal budget and the cascade's knobs, and the counter
    of host reads."""

    sp: Speedup
    ladder: object
    x_all: torch.Tensor
    w_all: torch.Tensor
    B_key: float
    plan_latency: float
    rtol: float
    cert_rtol: float
    knobs: dict
    read: HostReads = dataclasses.field(default_factory=HostReads)


def _event_arrays(stream: ArrivalStream):
    """Merged event arrays, ordered exactly like the host loop
    (time-stable, arrivals before budget steps at ties, end last)."""
    N = len(stream)
    t_all = np.asarray(stream.t, float)
    ev = [(float(t_all[j]), 0, j, 0.0) for j in range(N)]
    ev += [(float(bt), 1, 0, float(bv)) for bt, bv in
           zip(stream.budget_times, stream.budget_values)]
    ev.sort(key=lambda e: (e[0], e[1]))
    t_e = np.array([e[0] for e in ev] + [float(stream.horizon)], float)
    kind = np.array([1 if e[1] == 0 else 2 for e in ev] + [3], np.int32)
    pi = np.array([e[2] for e in ev] + [0], np.int32)
    pf = np.array([e[3] for e in ev] + [0.0], float)
    return t_e, kind, pi, pf


def _stream_state0(M: int, N: int, B: float, dtype=torch.float64,
                   device=None) -> dict:
    """Initial carry on ``device``: empty slots, no plans, cold warm
    payload.  ``completion`` has one slot past the N jobs: the sink that
    completions of no job are written to (a scatter cannot drop them)."""
    dev = resolve_device(device)
    n = max(N, 1)
    i64 = dict(dtype=torch.int64, device=dev)
    f = dict(dtype=dtype, device=dev)
    b = dict(dtype=torch.bool, device=dev)
    warm = stream_warm0(M, dtype, dev)
    state = {
        "t": torch.zeros((), **f),
        "rem": torch.zeros((M,), **f),
        "wslot": torch.zeros((M,), **f),
        "active": torch.zeros((M,), **b),
        "jos": torch.full((M,), -1, **i64),
        "B_live": torch.full((), B, **f),
        "order": torch.arange(M, **i64),
        "table": torch.zeros((M, M), **f),
        "m_front": torch.zeros((), **i64),
        "has_front": torch.zeros((), **b),
        "border": torch.arange(M, **i64),
        "btable": torch.zeros((M, M), **f),
        "m_back": torch.zeros((), **i64),
        "bready": torch.full((), -torch.inf, **f),
        "has_back": torch.zeros((), **b),
        "qbuf": torch.zeros((n,), **i64),
        "qhead": torch.zeros((), **i64),
        "qtail": torch.zeros((), **i64),
        "completion": torch.full((n + 1,), torch.inf, **f),
        "warm_lam": warm.lam,
        "warm_bracket": warm.bracket,
    }
    state.update({k: torch.zeros((), **i64) for k in _COUNTERS})
    return state


def _counters(state) -> dict:
    """The carry's counters on the host (one read for all)."""
    return dict(zip(_COUNTERS,
                    torch.stack([state[k] for k in _COUNTERS]).tolist()))


def _promote(s: dict, now) -> dict:
    """PlanBuffer.poll on the carry: back → front once ready (masks)."""
    s = dict(s)
    go = s["has_back"] & (now >= s["bready"])
    s["order"] = torch.where(go, s["border"], s["order"])
    s["table"] = torch.where(go, s["btable"], s["table"])
    s["m_front"] = torch.where(go, s["m_back"], s["m_front"])
    s["has_front"] = s["has_front"] | go
    s["has_back"] = s["has_back"] & ~go
    return s


def _fill_slots(s: dict, loop: _Loop) -> dict:
    """Queued jobs into free slots, FIFO, lowest slot first — the host
    loop's fill_free_slots.  One host read: how many jobs land."""
    n = loop.read(torch.minimum(s["qtail"] - s["qhead"],
                                (~s["active"]).sum()))
    if n == 0:
        return s
    s = dict(s)
    for _ in range(n):
        j = s["qbuf"].index_select(0, s["qhead"].reshape(1))
        slot = (~s["active"]).to(torch.int8).argmax().reshape(1)
        s["rem"] = s["rem"].index_put((slot,), loop.x_all[j])
        s["wslot"] = s["wslot"].index_put((slot,), loop.w_all[j])
        s["active"] = s["active"].index_put(
            (slot,), torch.ones((1,), dtype=torch.bool, device=slot.device))
        s["jos"] = s["jos"].index_put((slot,), j)
        s["qhead"] = s["qhead"] + 1
    return s


def _replan_dev(s: dict, t_now, loop: _Loop) -> dict:
    """_replan on the carry: cascade solve, publish to the back buffer
    (certified plans behind the solve latency, the ladder instantly)."""
    s = dict(s)
    warm = WarmStart(lam=s["warm_lam"], bracket=s["warm_bracket"])
    order, table, m, certified, searched, _, _, warm2 = stream_replan_core(
        loop.sp, loop.ladder, s["rem"], s["wslot"], s["active"],
        s["B_live"], loop.B_key, warm, loop.cert_rtol, read=loop.read,
        **loop.knobs)
    s["border"] = order
    s["btable"] = table
    s["m_back"] = m
    s["bready"] = (t_now + loop.plan_latency if certified
                   else torch.full_like(s["bready"], -torch.inf))
    s["has_back"] = torch.ones_like(s["has_back"])
    s["warm_lam"] = warm2.lam
    s["warm_bracket"] = warm2.bracket
    s["replans"] = s["replans"] + 1
    s["degraded"] = s["degraded"] + int(not certified)
    s["warm_ct"] = s["warm_ct"] + int(certified and not searched)
    s["cold_ct"] = s["cold_ct"] + int(searched or not certified)
    s["searches"] = s["searches"] + int(searched)
    return s


def _window(st: dict, t_ev, run: bool, loop: _Loop) -> dict:
    """One execution window from ``st["t"]`` (front plan promoted): to
    the back plan's ready time or ``t_ev``, cut at the first completion
    while jobs are queued (then backfill and replan at the cut)."""
    t0 = st["t"]
    t_stop = torch.where(st["has_back"] & (st["bready"] < t_ev),
                         st["bready"], t_ev)
    st = dict(st)
    if not run:
        # no plan or no live job: the window only moves the clock
        st["t"] = t_stop
        return st
    M = st["rem"].shape[0]
    idx = torch.arange(M, device=t0.device)
    rows = st["order"]
    cov = idx < st["m_front"]
    rem_rows = torch.where(cov, st["rem"][rows], 0.0)
    live0 = cov & st["active"][rows] & (rem_rows > 0)
    queued = st["qtail"] > st["qhead"]
    rem_e, live_e, comp = _exec_window(loop.sp, st["table"], rem_rows,
                                       live0, t_stop - t0, loop.rtol)
    # cut at the first completion, exactly the host algorithm: if jobs
    # are queued and the first completion lands strictly inside the
    # window, re-run the same loop on the shorter span
    c0 = torch.min(torch.where(torch.isfinite(comp), comp, torch.inf))
    do_cut = loop.read(queued & torch.isfinite(c0) & (t0 + c0 < t_stop))
    if do_cut:
        rem_e, live_e, comp = _exec_window(loop.sp, st["table"], rem_rows,
                                           live0, c0, loop.rtol)
        t_end = t0 + c0
    else:
        t_end = t_stop
    # the window's result back to slot coords; retire the completed
    newly = live0 & ~live_e
    jobs_r = st["jos"][rows]
    st["rem"] = st["rem"].index_put(
        (rows,), torch.where(live0, rem_e, st["rem"][rows]))
    sink = st["completion"].shape[0] - 1
    cjob = torch.where(newly, jobs_r, sink)
    st["completion"] = st["completion"].index_put((cjob,), t0 + comp)
    st["active"] = st["active"].index_put(
        (rows,), torch.where(newly, False, st["active"][rows]))
    st["jos"] = st["jos"].index_put((rows,), torch.where(newly, -1, jobs_r))
    st["n_windows"] = st["n_windows"] + 1
    st["t"] = t_end
    # backfill freed slots and replan at the cut time (the host's
    # "if t_end < t_stop and fill_free_slots()" branch; queued holds)
    if do_cut and loop.read(newly.any()):
        st = _replan_dev(_fill_slots(st, loop), t_end, loop)
    return st


def _exec_until(s: dict, t_ev, loop: _Loop) -> dict:
    """Execute up to ``t_ev`` on the front plan — the host loop's inner
    ``while t_cur < t_ev`` with its two window splits: (a) where a
    back-buffered plan comes ready, (b) at the first completion while
    jobs are queued (backfill + replan at the completion time).  One
    host read a window (behind, and whether a plan has live jobs to
    run), and one at the end."""
    while True:
        s = _promote(s, s["t"])
        behind, run = loop.read(torch.stack(
            [s["t"] < t_ev, s["has_front"] & s["active"].any()]))
        if not behind:
            return s
        s = _window(s, t_ev, run, loop)


def _stream_event(s: dict, ev, loop: _Loop) -> dict:
    """One control-plane event: execute-up-to, apply, replan.  ``ev`` is
    ``(t_ev, kind, pi, pf)``: the time and the payloads as 0-d device
    tensors, the kind a host int (a pad event is a no-op)."""
    t_ev, kind, pi, pf = ev
    if kind == 0:
        return s
    s = _exec_until(s, t_ev, loop)
    s = _fill_slots(_promote(s, t_ev), loop)
    if kind == 1:
        s = dict(s)
        s["qbuf"] = s["qbuf"].index_put((s["qtail"].reshape(1),),
                                        pi.reshape(1))
        s["qtail"] = s["qtail"] + 1
        s = _fill_slots(s, loop)
    elif kind == 2:
        s = dict(s)
        s["B_live"] = pf
    if kind in (1, 2):
        s = _replan_dev(s, t_ev, loop)
    return s


def _stream_chunk(state: dict, events, loop: _Loop) -> dict:
    """Service one chunk of events (host arrays ``(t_e, kind, pi, pf)``)
    on the carry's device."""
    dev = state["t"].device
    t_e, kind, pi, pf = events
    t_dev = as_tensor(np.asarray(t_e, float), dev, state["t"].dtype)
    pi_dev = as_tensor(np.asarray(pi, np.int64), dev)
    pf_dev = as_tensor(np.asarray(pf, float), dev, state["t"].dtype)
    for i in range(len(kind)):
        state = _stream_event(state, (t_dev[i], int(kind[i]), pi_dev[i],
                                      pf_dev[i]), loop)
    return state
