"""Port vs JAX: the host half of the streaming control plane
(``serve/stream.py``).

The window executor (``_exec_window``: a single job's rate, SmartFill's
completions, the non-prefix rank compression, float32 and its normal
rate floor), the double buffer, and ``StreamController.run`` — the host
loop, which is the device loop's oracle — against the JAX package's
``run`` on the same numpy traces: the same counts and finished sets,
completions and weighted J to 1e-9 relative, and the reference's odd
outcomes reproduced (139 of 141 arrivals completed on the committed
trace).  Also rank-mode admission, the ladder under a broken planner,
and the rejections.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.sched.policies as JP
import repro.serve as JS
import repro.serve.stream as JSTREAM
import repro_torch.core as P
from repro.core.workloads import load_arrival_log as jax_load_log
from repro.serve.admission import AdmissionController as JAdmission
from repro_torch.core.workloads import ArrivalStream, load_arrival_log
from repro_torch.sched.policies import StreamingSmartFillPolicy, StreamPlan
from repro_torch.serve import (AdmissionController, PlanBuffer,
                               StreamCascadePolicy, StreamController)
from repro_torch.serve.stream import _exec_window, _rate_floor
from torch_port_util import np_

B = 10.0
TRACE = (pathlib.Path(__file__).resolve().parents[1] / "benchmarks"
         / "traces" / "arrivals_sample.csv")


def SP(dtype=torch.float64):
    return P.power(1.0, 0.5, B, device="cpu", dtype=dtype)


def JSP():
    return J.power(1.0, 0.5, B)


def s_of(th):
    return float(SP().s(torch.tensor(th, dtype=torch.float64)))


# ---------------------------------------------------------------------------
# The window executor
# ---------------------------------------------------------------------------

def test_exec_window_single_job_rate():
    # one live row at θ = B runs at s(B); completion offset = rem/s(B)
    M = 4
    table = torch.zeros((M, M), dtype=torch.float64)
    table[0, 0] = B
    rem0 = torch.zeros(M, dtype=torch.float64)
    rem0[0] = 4.0
    live0 = torch.zeros(M, dtype=torch.bool)
    live0[0] = True
    rem, live, comp = _exec_window(SP(), table, rem0, live0, 100.0, 1e-12)
    assert not bool(live[0])
    np.testing.assert_allclose(float(comp[0]), 4.0 / s_of(B), rtol=1e-9)
    rem2, live2, comp2 = _exec_window(SP(), table, rem0, live0, 1.0, 1e-12)
    assert bool(live2[0]) and not np.isfinite(float(comp2[0]))
    np.testing.assert_allclose(float(rem2[0]), 4.0 - s_of(B), rtol=1e-9)
    jout = JSTREAM._exec_window(JSP(), jnp.asarray(np_(table)),
                                jnp.asarray(np_(rem0)), jnp.asarray(np_(live0)),
                                1.0, 1e-12)
    for got, ref in zip((rem2, live2, comp2), jout):
        np.testing.assert_allclose(np_(got), np.asarray(ref), rtol=1e-15)


def test_exec_window_matches_smartfill_completions():
    # the full SmartFill table of a 3-job instance: the window reproduces
    # the planned completion times
    x = np.array([6.0, 3.0, 1.5])
    sched = P.smartfill(SP(), x, np.ones(3), B=B)
    rem, live, comp = _exec_window(SP(), sched.theta, torch.tensor(x),
                                   torch.ones(3, dtype=torch.bool), 1e4,
                                   1e-12)
    assert not bool(live.any())
    np.testing.assert_allclose(np_(comp), np_(sched.T), rtol=1e-8)
    ref = JSTREAM._exec_window(JSP(), jnp.asarray(np_(sched.theta)),
                               jnp.asarray(x), jnp.ones(3, bool), 1e4, 1e-12)
    np.testing.assert_allclose(np_(comp), np.asarray(ref[2]), rtol=1e-12)


def test_exec_window_non_prefix_live_rank_compression():
    # stale-plan case: live rows {0, 2} of a 3-row table read column 1
    # (two active) at ranks 0 and 1
    table = torch.tensor([[4.0, 6.0, 5.0],
                          [0.0, 4.0, 3.0],
                          [0.0, 0.0, 2.0]], dtype=torch.float64)
    rem0 = torch.tensor([5.0, 0.0, 4.0], dtype=torch.float64)
    live0 = torch.tensor([True, False, True])
    rem, live, comp = _exec_window(SP(), table, rem0, live0, 0.5, 1e-12)
    np.testing.assert_allclose(float(rem[0]), 5.0 - 0.5 * s_of(6.0),
                               rtol=1e-9)
    np.testing.assert_allclose(float(rem[2]), 4.0 - 0.5 * s_of(4.0),
                               rtol=1e-9)
    assert float(rem[1]) == 0.0 and not bool(live[1])


def test_rate_floor_is_normal_in_both_dtypes():
    # a literal 1e-300 is *zero* in float32: exactly the unprotected
    # division the floor exists to prevent
    assert np.float32(1e-300) == 0.0
    for dt in (torch.float32, torch.float64):
        floor = torch.tensor(_rate_floor(dt), dtype=dt)
        assert float(floor) > 0.0
        assert float(floor) >= torch.finfo(dt).tiny     # normal
        assert float(floor) == float(JSTREAM._rate_floor(
            jnp.float32 if dt == torch.float32 else jnp.float64))
    assert _rate_floor(torch.float64) < 1e-290


def test_f32_denormal_rate_division_is_protected():
    one = torch.tensor(1.0, dtype=torch.float32)
    rate = torch.tensor(1e-40, dtype=torch.float32)        # denormal, > 0
    assert float(rate) > 0.0
    old = torch.clamp_min(rate, float(np.float32(1e-300)))  # floor 0.0
    assert not np.isfinite(float(one / old))
    assert np.isfinite(float(one / torch.clamp_min(
        rate, _rate_floor(torch.float32))))


def test_exec_window_f32_stays_in_dtype_and_completes():
    dt = torch.float32
    table = torch.tensor([[4.0, 4.0], [0.0, 4.0]], dtype=dt)
    rem0 = torch.tensor([1.0, 2.0], dtype=dt)
    live0 = torch.tensor([True, True])
    rem, live, comp = _exec_window(SP(dt), table, rem0, live0, 100.0, 1e-6)
    assert rem.dtype == dt and comp.dtype == dt
    assert torch.isfinite(rem).all() and torch.isfinite(comp).all()
    assert not bool(live.any())
    ref = JSTREAM._exec_window(
        jax.tree_util.tree_map(lambda l: jnp.asarray(l, jnp.float32), JSP()),
        jnp.asarray(np_(table)), jnp.asarray(np_(rem0)), jnp.ones(2, bool),
        jnp.asarray(100.0, jnp.float32), jnp.asarray(1e-6, jnp.float32))
    np.testing.assert_allclose(np_(comp), np.asarray(ref[2]), rtol=1e-6)


# ---------------------------------------------------------------------------
# The double buffer
# ---------------------------------------------------------------------------

def _plan(tag, m=2):
    return StreamPlan(order=np.arange(m), table=torch.full((4, 4), tag),
                      J=tag, J_linear=tag, m=m, B=B, warm=False,
                      certified=True)


def test_plan_buffer_promotes_at_ready_time():
    buf = PlanBuffer()
    assert buf.poll(0.0) is None
    p1, p2 = _plan(1.0), _plan(2.0)
    buf.publish(p1, ready_at=5.0)
    assert buf.poll(np.nextafter(5.0, -np.inf)) is None
    assert buf.poll(5.0) is p1                   # the closed boundary
    buf.publish(p2, ready_at=7.0)
    assert buf.poll(6.0) is p1                   # front stays while back solves
    assert buf.poll(7.5) is p2
    assert buf.swaps == 2
    q = _plan(3.0)
    buf.publish(q)                               # default -inf: instant
    assert buf.poll(-1e30) is q
    r, s = _plan(4.0), _plan(5.0)
    buf.publish(r, ready_at=8.0)
    buf.publish(s, ready_at=9.0)                 # latest wins
    assert buf.poll(8.5) is q
    assert buf.poll(9.0) is s


# ---------------------------------------------------------------------------
# The host loop against the JAX package's
# ---------------------------------------------------------------------------

def _assert_run_matches(got, ref, rtol=1e-9):
    fin = np.isfinite(ref.completion)
    np.testing.assert_array_equal(np.isfinite(got.completion), fin)
    np.testing.assert_allclose(got.completion[fin], ref.completion[fin],
                               rtol=rtol)
    for f in ("replans", "warm_replans", "cold_replans",
              "degraded_windows", "n_events"):
        assert getattr(got, f) == getattr(ref, f), f
    gm, rm = got.metrics, ref.metrics
    for f in ("n_arrivals", "n_admitted", "n_rejected", "n_completed",
              "deadline_misses", "deadline_total"):
        assert getattr(gm, f) == getattr(rm, f), f
    for f in ("weighted_J", "mean_flow", "mean_slowdown", "p50_latency",
              "p99_latency"):
        np.testing.assert_allclose(getattr(gm, f), getattr(rm, f),
                                   rtol=rtol)


def _stream(seed, horizon, *, rate, weights="slowdown", n_budget_events=2,
            **kw):
    return P.sample_arrival_stream(
        seed, horizon=horizon, rate=rate, diurnal=0.75, period=horizon,
        weights=weights, B=B, n_budget_events=n_budget_events,
        budget_frac=(0.3, 0.8), **kw)


def _cascade_pair(M, latency=0.0):
    ctl = StreamController(SP(), B, max_live=M,
                           policy=StreamCascadePolicy(SP(), B),
                           plan_latency=latency)
    jctl = JS.StreamController(JSP(), B, max_live=M,
                               policy=JS.StreamCascadePolicy(JSP(), B),
                               plan_latency=latency)
    return ctl, jctl


@pytest.mark.parametrize("seed,M,latency,weights,rate", [
    (3, 6, 0.0, "slowdown", 0.15),     # warm cascade only
    (11, 5, 2.0, "slowdown", 0.12),    # double-buffered mid-window splits
    (5, 6, 0.0, "random", 0.25),       # non-agreeable: search and ladder
])
def test_run_matches_jax(seed, M, latency, weights, rate):
    stream = _stream(seed, 1200.0, rate=rate, weights=weights)
    ctl, jctl = _cascade_pair(M, latency)
    _assert_run_matches(ctl.run(stream), jctl.run(stream))


def test_committed_trace_matches_jax():
    # the reference completes 139 of the trace's 141 arrivals; the port
    # must reproduce that, not "fix" it
    stream = load_arrival_log(TRACE)
    ctl, jctl = _cascade_pair(8)
    got = ctl.run(stream)
    assert (got.metrics.n_arrivals, got.metrics.n_completed) == (141, 139)
    assert got.replans == 145 and got.cold_replans == 3
    _assert_run_matches(got, jctl.run(jax_load_log(TRACE)))


def test_default_policy_warm_equals_cold_and_matches_jax():
    # the streaming policy's warm path over a trace with deep budget
    # dips: the same run as the cold-only baseline (J 1e-10) and as the
    # JAX package's warm run
    stream = P.sample_arrival_stream(3, horizon=1000.0, rate=0.2, B=B,
                                     n_budget_events=3,
                                     budget_frac=(0.15, 0.35),
                                     deadline_slack=50.0)

    class ColdOnly(StreamingSmartFillPolicy):
        def plan(self, rem, w, active=None, B=None, warm=True):
            return super().plan(rem, w, active=active, B=B, warm=False)

    rw = StreamController(SP(), B, max_live=8).run(stream)
    rc = StreamController(SP(), B, max_live=8,
                          policy=ColdOnly(SP(), B)).run(stream)
    assert rw.warm_replans > 0 and rc.warm_replans == 0
    assert rw.degraded_windows == rc.degraded_windows == 0
    assert abs(rw.metrics.weighted_J - rc.metrics.weighted_J) <= (
        1e-10 * max(1.0, abs(rc.metrics.weighted_J)))
    assert rw.metrics.n_completed == rc.metrics.n_completed
    _assert_run_matches(rw, JS.StreamController(JSP(), B,
                                                max_live=8).run(stream))


def test_plan_latency_jobs_idle_until_promotion():
    L, x = 3.0, 4.0
    stream = ArrivalStream(t=np.array([0.0]), x=np.array([x]),
                           w=np.ones(1), deadline=np.full(1, np.inf),
                           horizon=1000.0, budget_times=np.zeros(0),
                           budget_values=np.zeros(0))
    res = StreamController(SP(), B, max_live=4, plan_latency=L).run(stream)
    np.testing.assert_allclose(res.completion[0], L + x / s_of(B), rtol=1e-8)
    res0 = StreamController(SP(), B, max_live=4).run(stream)
    np.testing.assert_allclose(res0.completion[0], x / s_of(B), rtol=1e-8)


def test_capacity_queues_fifo():
    stream = ArrivalStream(t=np.zeros(3), x=np.full(3, 2.0), w=np.ones(3),
                           deadline=np.full(3, np.inf), horizon=1000.0,
                           budget_times=np.zeros(0),
                           budget_values=np.zeros(0))
    res = StreamController(SP(), B, max_live=1).run(stream)
    np.testing.assert_allclose(np.sort(res.completion),
                               2.0 / s_of(B) * np.arange(1, 4), rtol=1e-6)


# ---------------------------------------------------------------------------
# Admission, the ladder, the rejections
# ---------------------------------------------------------------------------

def test_rank_mode_admission_matches_jax():
    stream = P.sample_arrival_stream(11, horizon=4000.0, rate=0.02, B=B)
    assert len(stream) >= 5
    deny = StreamController(SP(), B, max_live=8, admission=AdmissionController(
        SP(), B=B, cost_threshold=-1.0, agreeable="rank")).run(stream)
    assert deny.metrics.n_rejected == len(stream)
    assert deny.metrics.n_completed == 0
    # a threshold above a lone job's marginal cost 1/s(B) = 0.316 and
    # below that of an arrival into a busy live set: some admitted, some
    # rejected, the same ones in both packages
    stream = P.sample_arrival_stream(11, horizon=400.0, rate=0.3, B=B)
    thr = 0.35
    got = StreamController(SP(), B, max_live=8, admission=AdmissionController(
        SP(), B=B, cost_threshold=thr, agreeable="rank")).run(stream)
    ref = JS.StreamController(JSP(), B, max_live=8, admission=JAdmission(
        JSP(), B=B, cost_threshold=thr, agreeable="rank")).run(stream)
    np.testing.assert_array_equal(got.admitted, ref.admitted)
    assert 0 < got.metrics.n_admitted < len(stream)
    _assert_run_matches(got, ref)


def test_stream_requires_rank_mode_admission():
    with pytest.raises(ValueError, match="rank"):
        StreamController(SP(), B, admission=AdmissionController(
            SP(), B=B, agreeable="require"))


def test_uncertified_replan_falls_to_ladder():
    class Broken(StreamingSmartFillPolicy):
        def plan(self, rem, w, active=None, B=None, warm=True):
            raise FloatingPointError("poisoned solve")

    stream = P.sample_arrival_stream(5, horizon=4000.0, rate=0.01, B=B)
    res = StreamController(SP(), B, max_live=4,
                           policy=Broken(SP(), B)).run(stream)
    assert res.degraded_windows == res.replans > 0
    # the ladder's SmartFill rung is healthy, so jobs still finish
    assert res.metrics.n_completed == res.metrics.n_admitted

    class JBroken(JP.StreamingSmartFillPolicy):
        def plan(self, rem, w, active=None, B=None, warm=True):
            raise FloatingPointError("poisoned solve")

    _assert_run_matches(res, JS.StreamController(
        JSP(), B, max_live=4, policy=JBroken(JSP(), B)).run(stream))


def test_stream_rejects_per_job_speedup():
    sp_pj = P.stack_speedups([P.power(1.0, 0.4, B, device="cpu"),
                              P.power(1.0, 0.6, B, device="cpu")])
    with pytest.raises(ValueError, match="shared"):
        StreamController(sp_pj, B)
    # the per-job path lives in the policy directly
    p = StreamingSmartFillPolicy(sp_pj, B).plan(np.array([4.0, 2.0]),
                                                np.ones(2))
    assert p.certified and p.m == 2


def test_serve_exports():
    import repro_torch.serve as S
    for name in ("AdmissionController", "AdmissionDecision", "PlanBuffer",
                 "StreamCascadePolicy", "StreamController", "StreamMetrics",
                 "StreamResult", "ServeEngine"):
        assert hasattr(S, name), name
    assert S.StreamController is StreamController


def test_cuda_is_the_default_device():
    # no device and no tensors given: the port runs on CUDA, and asking
    # for it on a machine without a GPU raises
    with pytest.raises(RuntimeError, match="CUDA"):
        StreamController(SP(), B, device="cuda")
