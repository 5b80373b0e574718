"""Port vs JAX: the cluster scheduler (``sched/cluster.py``).

The same numpy sizes, weights and arrivals go to the JAX package's
``ClusterScheduler`` and to the port's (float64, ``device="cpu"``), each
job carrying its own package's speedup where it has one.  The cases
mirror ``tests/sched/test_cluster.py``: ``integerize`` exactly; plans
with J to 1e-9 and θ to 1e-9·B, shared and heterogeneous; allocations
with completed jobs and integer chips; the device simulate path and the
host loop (reallocation cost, ``min_delta``, integer chips, coincident
arrivals), each with the reference's event count and J to 1e-9; the
unstackable-speedup ``TypeError``; the flagged event-budget re-run; and
the fleet mesh of 1, 2 and 8 CPU shards bit for bit to no mesh.

Shared fleets run under a pure power (SmartFill's closed form) and under
ln(1 + θ/2), where the phase split μ* comes from a search that stops at
a flat minimum: there J still agrees to 1e-9 but θ only to 1e-7·B and
the event times to 1e-7 relative (the
port's SmartFill parity with JAX off the pure-power path; the
reference's own test holds θ to 1e-6·B).
"""
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as JC
import repro.sched.cluster as JCL
import repro_torch.core as P
import repro_torch.sched.cluster as PCL
from repro_torch.distributed import fleet_mesh
from torch_port_util import np_, port_speedup

B = 64.0
RTOL = 1e-9
# allocation tolerance in units of B: the heterogeneous fleets and the
# pure power to 1e-9, the shared log family to 1e-7 (see the docstring)
THETA = {"power": 1e-9, "log": 1e-7, "hetero": 1e-9}
FAMILIES = ("power", "log")


def _sizes(M):
    x = np.arange(M, 0, -1.0) * 100.0
    return x, 1.0 / x


def _jobs(mod, M=6, sp=None, arrivals=None, **kw):
    x, w = _sizes(M)
    arr = np.zeros(M) if arrivals is None else arrivals
    return [mod.Job(name=f"j{i}", size=float(x[i]), weight=float(w[i]),
                    arrival=float(arr[i]), **kw) for i in range(M)]


def _pair(M=6, arrivals=None):
    return (_jobs(JCL, M, arrivals=arrivals),
            _jobs(PCL, M, arrivals=arrivals))


def _shared(family="log"):
    sp = (JC.log_speedup(1.0, 0.5, B) if family == "log"
          else JC.power(1.0, 0.5, B))
    return sp, port_speedup(sp)


def _hetero_jobs(mod, sps):
    """Three jobs, two with their own speedup (log, saturating), one on
    the scheduler-wide function (tests/sched/test_cluster.py)."""
    x = np.array([800.0, 500.0, 200.0])
    return [mod.Job(name="log", size=x[0], weight=1 / x[0], speedup=sps[0]),
            mod.Job(name="sat", size=x[1], weight=1 / x[1], speedup=sps[1]),
            mod.Job(name="default", size=x[2], weight=1 / x[2])]


def _hetero_pair():
    jsps = [JC.log_speedup(1.0, 1.0, B), JC.saturating(1.0, 1.5 * B, 2.0, B)]
    jdef = JC.neg_power(1.0, 4.0, -1.0, B)
    return ((JCL.ClusterScheduler(jdef, B), _hetero_jobs(JCL, jsps)),
            (PCL.ClusterScheduler(port_speedup(jdef), B),
             _hetero_jobs(PCL, [port_speedup(s) for s in jsps])))


def _close_J(got, ref):
    assert abs(got - ref) <= RTOL * abs(ref), (got, ref)


def _same_run(got, ref, family="hetero"):
    """Two (events, J) runs: the same event count, J to 1e-9, event times
    (relative) and allocations (over B) to ``THETA[family]``."""
    (ev_g, J_g), (ev_r, J_r) = got, ref
    assert len(ev_g) == len(ev_r)
    _close_J(J_g, J_r)
    for (tg, thg), (tr, thr) in zip(ev_g, ev_r):
        assert abs(tg - tr) <= THETA[family] * max(1.0, abs(tr))
        np.testing.assert_allclose(np_(thg), np.asarray(thr), rtol=0,
                                   atol=THETA[family] * B)


# ---- integerize -------------------------------------------------------------
@pytest.mark.parametrize("seed", range(4))
def test_integerize_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        n = int(rng.integers(1, 12))
        theta = rng.uniform(0.0, 30.0, n)
        if rng.uniform() < 0.2:
            theta[rng.integers(0, n)] = 0.0
        budget = int(rng.integers(1, 200))
        out = PCL.integerize(theta, budget)
        ref = JCL.integerize(theta, budget)
        assert out.dtype == ref.dtype == np.int64
        assert np.array_equal(out, ref)
        assert out.sum() == (budget if theta.sum() > 0 else 0)


def test_integerize_edges_equal_the_reference():
    for theta in (np.zeros(4), np.array([]), np.array([16.0, 16.0, 32.0]),
                  np.array([10.7, 20.2, 33.1])):
        out, ref = PCL.integerize(theta, 64), JCL.integerize(theta, 64)
        assert out.shape == ref.shape and out.dtype == ref.dtype
        assert np.array_equal(out, ref)


# ---- planning -----------------------------------------------------------------
def _plan_close(got, ref, m, family="hetero"):
    _close_J(float(got.J), float(ref.J))
    np.testing.assert_allclose(np_(got.theta)[:m, :m],
                               np.asarray(ref.theta)[:m, :m], rtol=0,
                               atol=THETA[family] * B)


@pytest.mark.parametrize("family", FAMILIES)
def test_plan_fleets_shared_matches_jax(family):
    jsp, psp = _shared(family)
    sizes = (3, 6, 5)
    jf = [_jobs(JCL, m) for m in sizes]
    pf = [_jobs(PCL, m) for m in sizes]
    jo, jb = JCL.ClusterScheduler(jsp, B).plan_fleets(jf)
    po, pb = PCL.ClusterScheduler(psp, B).plan_fleets(pf)
    assert po == [list(o) for o in jo]
    assert pb.theta.dtype == torch.float64 and pb.theta.device.type == "cpu"
    for n, m in enumerate(sizes):
        _plan_close(pb.instance(n), jb.instance(n), m, family)
    # the single-fleet view
    o1, s1 = PCL.ClusterScheduler(psp, B).plan(pf[1])
    r1, ref1 = JCL.ClusterScheduler(jsp, B).plan(jf[1])
    assert list(o1) == list(r1)
    _plan_close(s1, ref1, 6, family)


def test_plan_heterogeneous_matches_jax():
    (jcs, jjobs), (pcs, pjobs) = _hetero_pair()
    jo, js = jcs.plan(jjobs)
    po, ps = pcs.plan(pjobs)
    assert list(po) == list(np.asarray(jo))
    _plan_close(ps, js, 3)
    # several fleets of it, one completed job in the second
    pjobs2 = _hetero_pair()[1][1]
    jjobs2 = _hetero_pair()[0][1]
    for fl in (pjobs2, jjobs2):
        fl[0].done = 2.0
    jo, jb = jcs.plan_fleets([jjobs, jjobs2])
    po, pb = pcs.plan_fleets([pjobs, pjobs2])
    assert po == [list(o) for o in jo]
    for n, m in enumerate((3, 2)):
        _plan_close(pb.instance(n), jb.instance(n), m)


# ---- current allocations ------------------------------------------------------
def _done_fleet(mod):
    fleet = _jobs(mod, 4)
    fleet[1].done = 3.0
    fleet.append(mod.Job(name="finished", size=0.0, weight=1.0, done=1.0))
    return fleet


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("integer_chips", [False, True])
def test_current_allocations_fleets_match_jax(integer_chips, family):
    jsp, psp = _shared(family)
    jcs = JCL.ClusterScheduler(jsp, B, integer_chips=integer_chips)
    pcs = PCL.ClusterScheduler(psp, B, integer_chips=integer_chips)
    jf = [_jobs(JCL, 4), _done_fleet(JCL), _jobs(JCL, 6)]
    pf = [_jobs(PCL, 4), _done_fleet(PCL), _jobs(PCL, 6)]
    got = pcs.current_allocations_fleets(pf)
    ref = jcs.current_allocations_fleets(jf)
    for g, r in zip(got, ref):
        assert isinstance(g, np.ndarray) and g.dtype == np.float64
        if integer_chips:
            assert np.array_equal(g, r) and g.sum() == B
        else:
            np.testing.assert_allclose(g, r, rtol=0, atol=THETA[family] * B)
            assert abs(g.sum() - B) < 1e-9 * B
    assert got[1][1] == 0.0 and got[1][-1] == 0.0
    np.testing.assert_array_equal(got[1], pcs.current_allocations(pf[1]))


def test_all_fleets_completed_keep_their_shapes():
    _, psp = _shared()
    pcs = PCL.ClusterScheduler(psp, B)
    done = [PCL.Job("a", 0.0, 1.0, done=1.0), PCL.Job("b", 0.0, 1.0, done=2.0)]
    allocs = pcs.current_allocations_fleets([done, []])
    assert allocs[0].shape == (2,) and np.all(allocs[0] == 0.0)
    assert allocs[1].shape == (0,)
    assert pcs.current_allocations(done).shape == (2,)
    with pytest.raises(ValueError, match="no active jobs"):
        pcs.plan_fleets([done])


def test_heterogeneous_allocations_match_jax():
    (jcs, jjobs), (pcs, pjobs) = _hetero_pair()
    got = pcs.current_allocations(pjobs)
    np.testing.assert_allclose(got, jcs.current_allocations(jjobs), rtol=0,
                               atol=RTOL * B)
    shared = pcs.current_allocations(
        [PCL.Job(name=j.name, size=j.size, weight=j.weight) for j in pjobs])
    assert not np.allclose(got, shared)      # Job.speedup is honoured


# ---- simulate -----------------------------------------------------------------
@pytest.mark.parametrize("family", FAMILIES)
def test_device_simulation_matches_jax(family):
    jsp, psp = _shared(family)
    jj, pj = _pair()
    ref = JCL.ClusterScheduler(jsp, B).simulate(jj)
    got = PCL.ClusterScheduler(psp, B).simulate(pj)
    assert isinstance(got, PCL.ClusterSimResult)
    assert got.ok and got.path == "device" and got.status == "ok"
    _same_run(got, ref, family)
    events, J = got
    assert J == got.J and events is got.events
    x, w = _sizes(6)
    _close_J(got.J, JC.smartfill(jsp, x, w, B=B).J)


@pytest.mark.parametrize("family", FAMILIES)
def test_host_loop_with_reallocation_cost_matches_jax(family):
    jsp, psp = _shared(family)
    for cost, delta in ((5.0, 0.5), (5.0, 4.0)):
        jj, pj = _pair()
        ref = JCL.ClusterScheduler(jsp, B, realloc_cost_s=cost,
                                   min_delta=delta).simulate(jj)
        got = PCL.ClusterScheduler(psp, B, realloc_cost_s=cost,
                                   min_delta=delta).simulate(pj)
        assert got.path == ref.path == "host"
        _same_run(got, ref, family)
    # the reference's own ordering of the runs holds in the port
    J0 = PCL.ClusterScheduler(psp, B).simulate(_pair()[1]).J
    J1 = PCL.ClusterScheduler(psp, B, realloc_cost_s=5.0).simulate(
        _pair()[1]).J
    assert J1 > J0


def test_integer_chips_match_jax():
    jsp, psp = _shared()
    jj, pj = _pair()
    ref = JCL.ClusterScheduler(jsp, B, integer_chips=True).simulate(jj)
    got = PCL.ClusterScheduler(psp, B, integer_chips=True).simulate(pj)
    assert got.path == "host"
    _same_run(got, ref, "log")
    for _, th in got.events:
        assert np.array_equal(th, np.round(th)) and th.sum() == B


@pytest.mark.parametrize("path", ["device", "host"])
def test_coincident_arrivals_match_jax(path):
    jsp, psp = _shared()
    arr = np.array([0.0, 0.0, 0.0, 1.0, 1.0])
    jj, pj = _pair(5, arrivals=arr)
    kw = {} if path == "device" else {"realloc_cost_s": 0.5}
    ref = JCL.ClusterScheduler(jsp, B, **kw).simulate(jj)
    got = PCL.ClusterScheduler(psp, B, **kw).simulate(pj)
    assert got.path == path
    _same_run(got, ref, "log")
    post = np.array([th for t, th in got.events if t >= 1.0])
    assert post.size and post[:, 3].max() > 0 and post[:, 4].max() > 0
    assert any(abs(t - 1.0) < 1e-9 for t, _ in got.events)


def test_completed_jobs_add_their_flow_time():
    jsp, psp = _shared()
    jj, pj = _pair()
    for fl in (jj, pj):
        fl[2].done, fl[2].arrival = 7.0, 0.5
    ref = JCL.ClusterScheduler(jsp, B).simulate(jj)
    got = PCL.ClusterScheduler(psp, B).simulate(pj)
    _same_run(got, ref, "log")


def test_heterogeneous_simulation_matches_jax_on_both_paths():
    (jcs, jjobs), (pcs, pjobs) = _hetero_pair()
    ref_dev = jcs.simulate([JCL.Job(**vars(j)) for j in jjobs])
    got_dev = pcs.simulate([PCL.Job(**vars(j)) for j in pjobs])
    ref_host = jcs.simulate_host([JCL.Job(**vars(j)) for j in jjobs])
    got_host = pcs.simulate_host([PCL.Job(**vars(j)) for j in pjobs])
    _same_run(got_dev, ref_dev)
    _same_run(got_host, ref_host)
    assert abs(got_dev.J - got_host[1]) / got_host[1] < 1e-5


def test_unstackable_speedup_raises_not_falls_back():
    (_, _), (pcs, _) = _hetero_pair()
    gen = P.GenericSpeedup(s_fn=torch.log1p, ds_fn=lambda t: 1.0 / (1.0 + t),
                           B=B)
    jobs = [PCL.Job(name="g", size=100.0, weight=0.01, speedup=gen),
            PCL.Job(name="ok", size=50.0, weight=0.02)]
    with pytest.raises(TypeError, match="cannot be stacked"):
        pcs.plan(jobs)
    with pytest.raises(TypeError, match="cannot be stacked"):
        pcs.simulate(jobs)
    cs_gen = PCL.ClusterScheduler(gen, B)
    jobs2 = [PCL.Job(name="a", size=100.0, weight=0.01,
                     speedup=P.neg_power(1.0, 4.0, -1.0, B, device="cpu")),
             PCL.Job(name="b", size=50.0, weight=0.02)]
    with pytest.raises(TypeError, match="scheduler-wide"):
        cs_gen.plan(jobs2)


def test_event_budget_exhaustion_is_flagged_and_counted(monkeypatch,
                                                        caplog):
    class Unfinished:
        J = float("inf")
        T = np.zeros(2)
        events = []
        n_events = 0

    monkeypatch.setattr(P, "simulate_policy_device",
                        lambda *a, **k: Unfinished())
    monkeypatch.setattr(PCL, "_warned_device_fallback", False)
    _, psp = _shared()
    cs = PCL.ClusterScheduler(psp, B)
    with caplog.at_level(logging.WARNING, logger=PCL.__name__):
        r1 = cs.simulate(_pair()[1])
        r2 = cs.simulate(_pair()[1])
    for r in (r1, r2):
        assert not r.ok and r.status == "device-event-budget-exhausted"
        assert r.path == "host" and np.isfinite(r.J)
    assert cs.device_fallbacks == 2
    assert len([rec for rec in caplog.records
                if "event budget" in rec.message]) == 1
    events, J_host = cs.simulate_host(_pair()[1])
    assert r1.J == J_host and len(r1.events) == len(events)


def test_simulate_runs_on_the_speedups_device():
    """The port's entry points run where the speedup lives: CPU leaves
    plan on the CPU; with no device and no GPU the default raises."""
    jsp, psp = _shared()
    res = PCL.ClusterScheduler(psp, B).simulate(_pair()[1])
    assert np.isfinite(res.J)
    monkey = pytest.MonkeyPatch()
    monkey.setattr(torch.cuda, "is_available", lambda: False)
    try:
        with pytest.raises(RuntimeError, match="no GPU"):
            PCL.ClusterScheduler(P.log_speedup(1.0, 0.5, B), B)
    finally:
        monkey.undo()


# ---- fleet meshes ---------------------------------------------------------------
FIELDS = ("theta", "c", "a", "durations", "T", "J", "J_linear", "m",
          "active")


def _fleets(mod, hetero_sps=None):
    rng = np.random.default_rng(5)
    out = []
    for n in range(11):
        k = int(rng.integers(1, 7))
        sizes = np.sort(rng.uniform(50.0, 500.0, k))[::-1]
        fleet = [mod.Job(name=f"f{n}j{i}", size=float(s),
                         weight=float(1.0 / s)) for i, s in enumerate(sizes)]
        if hetero_sps is not None and n % 3 == 0:
            fleet[0].speedup = hetero_sps[n % len(hetero_sps)]
        if n == 4:
            fleet[0].done = 1.0
        out.append(fleet)
    return out


@pytest.mark.parametrize("hetero", [False, True])
@pytest.mark.parametrize("D", [1, 2, 8])
def test_fleet_mesh_is_bit_for_bit_the_unsharded_call(D, hetero):
    psp = P.neg_power(1.0, 4.0, -1.0, B, device="cpu")
    sps = ([P.log_speedup(1.0, 1.0, B, device="cpu"),
            P.saturating(1.0, 1.5 * B, 2.0, B, device="cpu")]
           if hetero else None)
    cs = PCL.ClusterScheduler(psp, B)
    fleets = _fleets(PCL, sps)
    o0, s0 = cs.plan_fleets(fleets)
    a0 = cs.current_allocations_fleets(fleets)
    with fleet_mesh(D, device="cpu"):
        o1, s1 = cs.plan_fleets(fleets)
        a1 = cs.current_allocations_fleets(fleets)
    assert o0 == o1
    for f in FIELDS:
        x, y = getattr(s0, f), getattr(s1, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f
    for x, y in zip(a0, a1):
        assert np.array_equal(x, y)


def test_fleet_allocations_match_jax_on_a_mixed_batch():
    jsps = [JC.log_speedup(1.0, 1.0, B), JC.saturating(1.0, 1.5 * B, 2.0, B)]
    jdef = JC.neg_power(1.0, 4.0, -1.0, B)
    got = PCL.ClusterScheduler(port_speedup(jdef), B)\
        .current_allocations_fleets(
            _fleets(PCL, [port_speedup(s) for s in jsps]))
    ref = JCL.ClusterScheduler(jdef, B).current_allocations_fleets(
        _fleets(JCL, jsps))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, rtol=0, atol=RTOL * B)


def test_rates_of_the_host_loop_are_float64():
    (_, _), (pcs, pjobs) = _hetero_pair()
    slot = pcs.slot_speedup(pjobs)
    assert slot.A.dtype == torch.float64
    th = np.array([10.0, 20.0, 34.0])
    ref = np.asarray(PCL.ClusterScheduler(port_speedup(
        JC.neg_power(1.0, 4.0, -1.0, B)), B).slot_speedup(pjobs).s(
        torch.as_tensor(th, dtype=torch.float64)))
    got = np.asarray(slot.s(torch.as_tensor(th, dtype=torch.float64)))
    assert np.array_equal(got, ref)
    jslot = _hetero_pair()[0][0].slot_speedup(_hetero_pair()[0][1])
    np.testing.assert_allclose(got, np.asarray(jslot.s(jnp.asarray(th))),
                               rtol=1e-14)
