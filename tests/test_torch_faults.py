"""Port vs JAX: fault traces, the fault-aware host oracle and engine.

``sample_fault_traces`` draws everything with numpy from one seed, so
the port's traces must equal the JAX package's bit for bit (over the
reference's ``tests/robust/test_faults.py`` cases, ``snap_to``
included).  ``FaultTrace.validate`` refuses what the reference refuses.
The port's ``simulate_policy_reference`` with faults must agree with the
JAX one, and the port's fault-aware engine with both, at the reference's
tolerance RTOL = 1e-6 on J and T (budget steps, failure rework, full
failure, stragglers, coincident events, a fault on a completed job, and
65 seeded chaos traces over five families); hand-computed single-fault
cases hold to 1e-9 as in the reference.
"""
import jax
import numpy as np
import pytest

import repro.core as J
import repro.core.simulator as J_sim
import repro.sched.policies as JP
import repro_torch.core as P
import repro_torch.sched.policies as PP
from repro.core.workloads import sample_fault_traces as faults_j
from torch_port_util import assert_sim_match, port_speedup

B = 8.0
RTOL = 1e-6

FAMS = {
    "power": lambda: J.power(1.0, 0.5, B),
    "shifted": lambda: J.shifted_power(1.0, 4.0, 0.5, B),
    "log": lambda: J.log_speedup(1.0, 1.0, B),
    "neg_power": lambda: J.neg_power(5.0, 2.0, -1.0, B),
    "saturating": lambda: J.saturating(1.0, 12.0, 2.0, B),
}

SAMPLER_CASES = {
    "chaos_snapped": (100, 13, 5, dict(horizon=5.0, preempt_rate=0.6,
                                       fail_rate=0.4, straggle_rate=0.4,
                                       snap_to=[0.0, 0.3, 1.1, 1.7, 1.9],
                                       snap_frac=0.5)),
    "all_rates": (0, 8, 6, dict(horizon=5.0, preempt_rate=1.0,
                                fail_rate=1.0, straggle_rate=1.0)),
    "preempt_only": (7, 3, 4, dict(horizon=3.0, preempt_rate=1.0)),
    "snap_all_no_recover": (1, 4, 4, dict(horizon=3.0, preempt_rate=2.0,
                                          snap_to=np.array([0.5, 1.0, 2.0]),
                                          snap_frac=1.0, recover=False)),
    "ensemble": (4, 6, 4, dict(horizon=4.0, preempt_rate=0.7,
                               fail_rate=0.5, straggle_rate=0.5)),
    "knobs": (9, 5, 7, dict(horizon=6.0, preempt_rate=0.5, fail_rate=0.3,
                            straggle_rate=0.3, budget_frac=(0.1, 0.2),
                            repair_time=0.25, loss=(0.0, 0.3),
                            slow=(0.5, 0.6))),
    "empty": (3, 2, 3, dict(horizon=1.0)),
}


@pytest.mark.parametrize("case", list(SAMPLER_CASES))
def test_sample_fault_traces_bitwise(case):
    seed, K, M, kw = SAMPLER_CASES[case]
    ref = faults_j(seed, K, M, B=B, **kw)
    out = P.sample_fault_traces(seed, K, M, B=B, **kw)
    assert isinstance(out, P.FaultTrace) and out.batched and out.S == ref.S
    for name in ("times", "kinds", "jobs", "values"):
        a, r = getattr(out, name), getattr(ref, name)
        assert a.dtype == r.dtype and np.array_equal(a, r), name
    out.validate(M)
    with pytest.raises(ValueError, match="horizon"):
        P.sample_fault_traces(seed, K, M, B=B, horizon=0.0)


def _trace(mod, times, kinds, jobs, values):
    return mod.FaultTrace(times=np.asarray(times, float),
                          kinds=np.asarray(kinds, np.int32),
                          jobs=np.asarray(jobs, np.int32),
                          values=np.asarray(values, float))


BAD = {
    "unsorted": ([2.0, 1.0], [0, 0], [0, 0], [1.0, 1.0]),
    "unknown_kind": ([1.0], [7], [0], [1.0]),
    "budget_le_0": ([1.0], [J.KIND_BUDGET], [0], [-1.0]),
    "loss_gt_1": ([1.0], [J.KIND_FAILURE], [0], [1.5]),
    "rate_0": ([1.0], [J.KIND_STRAGGLER], [0], [0.0]),
    "job_out_of_range": ([1.0], [J.KIND_FAILURE], [3], [0.5]),
    "negative_time": ([-1.0], [J.KIND_BUDGET], [0], [1.0]),
    "nan_time": ([np.nan], [J.KIND_BUDGET], [0], [1.0]),
}


@pytest.mark.parametrize("case", list(BAD))
def test_validate_refuses_what_the_reference_refuses(case):
    spt = P.power(1.0, 0.5, B, device="cpu")
    x, w = np.array([2.0]), np.array([1.0])
    with pytest.raises(ValueError) as ej:
        _trace(J_sim, *BAD[case]).validate(1)
    with pytest.raises(ValueError) as et:
        _trace(P, *BAD[case]).validate(1)
    assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError):
        P.simulate_policy_device(spt, x, w, PP.EquiPolicy(B),
                                 faults=_trace(P, *BAD[case]))


def test_trace_shapes_and_batching_errors():
    spt = P.power(1.0, 0.5, B, device="cpu")
    with pytest.raises(ValueError, match="share one shape"):
        P.FaultTrace([1.0, 2.0], [0], [0], [1.0]).validate(2)
    with pytest.raises(ValueError, match="1-D or 2-D"):
        P.FaultTrace(np.ones((1, 1, 1)), np.zeros((1, 1, 1)),
                     np.zeros((1, 1, 1)), np.ones((1, 1, 1))).validate(2)
    tr = P.sample_fault_traces(0, 3, 2, B=B, horizon=2.0, preempt_rate=1.0)
    x, w = np.array([2.0, 1.0]), np.array([0.5, 1.0])
    with pytest.raises(ValueError, match="instance"):
        P.simulate_policy_reference(spt, x, w, PP.EquiPolicy(B).bind("cpu"),
                                    B=B, faults=tr)
    with pytest.raises(ValueError, match="1-D FaultTrace"):
        P.simulate_policy_device(spt, x, w, PP.EquiPolicy(B), faults=tr)
    with pytest.raises(ValueError, match="3 traces for K=2"):
        P.simulate_ensemble(spt, (PP.EquiPolicy(B),), np.tile(x, (2, 1)),
                            np.tile(w, (2, 1)), faults=tr)
    assert tr.instance(1).times.shape == (tr.S,)
    assert P.budget_trace([1.0], [2.0]).instance(0).S == 1


def _jitted(pol, Bown):
    fast = jax.jit(lambda rem, w, active, b: pol(rem, w, active, b))
    return lambda rem, w, active, b=None: np.asarray(
        fast(rem, w, active, Bown if b is None else b))


def _three(spj, x, w, mk_j, mk_p, tr_args, Bv=4.0, arrival=None):
    """(port engine, port oracle, JAX oracle) on one faulted instance."""
    spt = port_speedup(spj)
    pj, pt = mk_j(spj), mk_p(spt)
    out = P.simulate_policy_device(spt, x, w, pt, arrival=arrival,
                                   faults=_trace(P, *tr_args), device="cpu")
    ref_p = P.simulate_policy_reference(spt, x, w, pt.bind("cpu"), B=Bv,
                                        arrival=arrival,
                                        faults=_trace(P, *tr_args))
    ref = J.simulate_policy_reference(spj, x, w, _jitted(pj, Bv), B=Bv,
                                      arrival=arrival,
                                      faults=_trace(J_sim, *tr_args))
    return out, ref_p, ref


# name: (x, trace (times, kinds, jobs, values), hand-computed T or None)
SEMANTICS = {
    # until t=1: θ = 2 each, rate √2; after: θ = 0.5 each
    "budget_step": ([2.0, 2.0], ([1.0], [0], [0], [1.0]),
                    [1.0 + (2.0 - np.sqrt(2.0)) / np.sqrt(0.5)] * 2),
    # rate 2; at t = 1 rem = 1, rework 0.5·(x − rem) = 1 → rem = 2
    "failure_rework": ([3.0], ([1.0], [1], [0], [0.5]), [2.0]),
    "full_failure": ([3.0], ([1.0], [1], [0], [1.0]), [2.5]),
    # rate 2; at t = 1 rem = 2, multiplier 0.5 → rate 1 → T = 3
    "straggler": ([4.0], ([1.0], [2], [0], [0.5]), [3.0]),
    # completes at t = 1; a failure at t = 2 must not resurrect it
    "failure_after_completion": ([2.0], ([2.0], [1], [0], [1.0]), [1.0]),
    # failure exactly at the completion instant: completions first
    "failure_at_completion": ([2.0], ([1.0], [1], [0], [1.0]), [1.0]),
    "mixed": ([3.0, 2.0, 1.0], ([0.2, 0.2, 0.5, 0.9, 1.4],
                                [0, 2, 1, 2, 0], [0, 1, 0, 1, 0],
                                [2.0, 0.3, 0.7, 1.0, 4.0]), None),
}


@pytest.mark.parametrize("case", list(SEMANTICS))
def test_single_fault_semantics(case):
    x, tr, T_hand = SEMANTICS[case]
    x = np.asarray(x)
    w = np.ones_like(x)
    out, ref_p, ref = _three(J.power(1.0, 0.5, 4.0), x, w,
                             lambda sp: JP.EquiPolicy(4.0),
                             lambda sp: PP.EquiPolicy(4.0), tr)
    assert_sim_match(out, ref, RTOL, 4.0)
    assert_sim_match(ref_p, ref, RTOL, 4.0)
    if T_hand is not None:
        np.testing.assert_allclose(out.T, T_hand, rtol=1e-9)
        np.testing.assert_allclose(ref_p.T, T_hand, rtol=1e-9)


def test_coincident_budget_arrival_completion():
    """Budget step + arrival + completion at one instant, and a second
    coincident budget event draining through a dt = 0 step."""
    x = np.array([2.0, 3.0])
    w = np.array([1.0, 1.0])
    arrival = np.array([0.0, 1.0])
    out, ref_p, ref = _three(J.power(1.0, 0.5, 4.0), x, w,
                             lambda sp: JP.EquiPolicy(4.0),
                             lambda sp: PP.EquiPolicy(4.0),
                             ([1.0, 1.0], [0, 0], [0, 0], [2.0, 1.0]),
                             arrival=arrival)
    np.testing.assert_allclose(out.T, [1.0, 4.0], rtol=1e-9)
    assert_sim_match(out, ref, RTOL, 4.0)
    assert_sim_match(ref_p, ref, RTOL, 4.0)


@pytest.mark.parametrize("fam", list(FAMS))
def test_engine_matches_jax_under_chaos(fam):
    """13 seeded chaos traces per family (65 in all) as one batched
    port run (K = 13 copies of the instance, one trace each) against
    the JAX host oracle per trace: preemption and recovery, failures,
    stragglers, fault times snapped onto the arrivals."""
    spj = FAMS[fam]()
    seed = 100 + list(FAMS).index(fam)
    M = 5
    rng = np.random.default_rng(seed)
    x = np.sort(rng.uniform(1.0, 6.0, M))[::-1].copy()
    w = 1.0 / x
    arrival = np.concatenate([[0.0], np.sort(rng.uniform(0.0, 2.0, M - 1))])
    kw = dict(B=B, horizon=5.0, preempt_rate=0.6, fail_rate=0.4,
              straggle_rate=0.4, snap_to=arrival, snap_frac=0.5)
    tr_p = P.sample_fault_traces(seed, 13, M, **kw)
    tr_j = faults_j(seed, 13, M, **kw)
    spt = port_speedup(spj)
    K = 13
    res = P.simulate_ensemble(spt, (PP.GWFStaticPolicy(spt, B=B),),
                              np.tile(x, (K, 1)), np.tile(w, (K, 1)),
                              arrival=np.tile(arrival, (K, 1)), faults=tr_p,
                              device="cpu")
    ref_pol = _jitted(JP.GWFStaticPolicy(spj, B=B), B)
    for k in range(K):
        ref = J.simulate_policy_reference(spj, x, w, ref_pol, B=B,
                                          arrival=arrival,
                                          faults=tr_j.instance(k))
        assert np.isfinite(ref.J)
        Jk = float(res.J[0, k])
        assert abs(Jk - ref.J) / max(ref.J, 1e-12) < RTOL, (fam, k)
        np.testing.assert_allclose(res.T[0, k].numpy(), ref.T, rtol=RTOL,
                                   atol=RTOL)
        assert int(res.n_events[0, k]) == ref.n_events
        if k < 2:                       # the single-instance engine too
            one = P.simulate_policy_device(
                spt, x, w, PP.GWFStaticPolicy(spt, B=B), arrival=arrival,
                faults=tr_p.instance(k), device="cpu")
            assert_sim_match(one, ref, RTOL, B)


def test_engine_matches_jax_engine_faulted_ensemble():
    """The JAX fault-aware ``simulate_ensemble`` on the reference's
    ensemble case: SmartFill (closed-form μ*) and EQUI."""
    spj = J.power(1.0, 0.6, B)
    spt = port_speedup(spj)
    K, M = 6, 4
    wb = J.sample_workloads(3, K, M, B=B)
    kw = dict(B=B, horizon=4.0, preempt_rate=0.7, fail_rate=0.5,
              straggle_rate=0.5)
    ref = J.simulate_ensemble(spj, (JP.SmartFillPolicy(spj, B=B),
                                    JP.EquiPolicy(B)), wb.X, wb.W,
                              faults=faults_j(4, K, M, **kw))
    pols = (PP.SmartFillPolicy(spt, B=B), PP.EquiPolicy(B))
    tr = P.sample_fault_traces(4, K, M, **kw)
    res = P.simulate_ensemble(spt, pols, wb.X, wb.W, faults=tr,
                              device="cpu")
    np.testing.assert_allclose(res.J.numpy(), np.asarray(ref.J), rtol=RTOL)
    np.testing.assert_allclose(res.T.numpy(), np.asarray(ref.T), rtol=RTOL,
                               atol=RTOL)
    assert np.array_equal(res.n_events.numpy(), np.asarray(ref.n_events))
    # the ensemble row equals the single-instance run
    for p, pol in enumerate(pols):
        for k in range(K):
            one = P.simulate_policy_device(spt, wb.X[k], wb.W[k], pol,
                                           faults=tr.instance(k),
                                           device="cpu")
            assert abs(float(res.J[p, k]) - one.J) <= 1e-12 * max(1.0, one.J)


def test_shared_trace_broadcasts_over_ensemble():
    spt = P.power(1.0, 0.6, B, device="cpu")
    wb = P.sample_workloads(5, 4, 3, B=B)
    tr = P.budget_trace([0.5, 1.5], [3.0, B])
    pols = (PP.EquiPolicy(B),)
    res = P.simulate_ensemble(spt, pols, wb.X, wb.W, faults=tr)
    for k in range(4):
        one = P.simulate_policy_device(spt, wb.X[k], wb.W[k], pols[0],
                                       faults=tr)
        assert abs(float(res.J[0, k]) - one.J) <= 1e-12
    ref = J.simulate_ensemble(J.power(1.0, 0.6, B), (JP.EquiPolicy(B),),
                              wb.X, wb.W,
                              faults=J.budget_trace([0.5, 1.5], [3.0, B]))
    np.testing.assert_allclose(res.J.numpy(), np.asarray(ref.J), rtol=RTOL)


def test_faulted_run_needs_a_budget_and_sane_inputs():
    spt = P.power(1.0, 0.5, B, device="cpu")

    class NoB:
        device_ready = True
        name = "no-budget"

        def __call__(self, rem, w, active, b=None):
            return (active * 1.0).to(rem.dtype)

    with pytest.raises(ValueError, match="initial budget"):
        P.simulate_policy_device(spt, np.array([1.0]), np.array([1.0]),
                                 NoB(), faults=P.budget_trace([1.0], [2.0]))
    pol = PP.EquiPolicy(B)
    with pytest.raises(ValueError, match="finite"):
        P.simulate_policy_device(spt, np.array([np.inf]), np.array([1.0]),
                                 pol)
    with pytest.raises(ValueError, match="≥ 0"):
        P.simulate_policy_device(spt, np.array([-1.0]), np.array([1.0]),
                                 pol)
    with pytest.raises(ValueError, match="NaN"):
        P.simulate_policy_device(spt, np.array([1.0]), np.array([1.0]), pol,
                                 arrival=np.array([np.nan]))
    with pytest.raises(ValueError, match="finite and > 0"):
        P.simulate_policy_device(spt, np.array([1.0]), np.array([1.0]),
                                 PP.EquiPolicy(-2.0))
    with pytest.raises(ValueError):
        P.simulate_ensemble(spt, (pol,), np.array([[1.0, -2.0]]),
                            np.array([[1.0, 1.0]]))
