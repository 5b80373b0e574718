"""Port vs JAX: ``simulate_ensemble``, P policies × K workloads.

The port runs each policy as one batch-first event loop over the K
workloads; the JAX package vmaps its ``lax.scan`` over them.  On the
same numpy ensembles both give J and T to the reference's RTOL = 1e-6
(``tests/core/test_ensemble.py``), the same ``n_events`` and
``finished`` flags: the face-off zoo under ln(1+θ) at K = 16, M = 8
with its face-off table (SmartFill's mean gap 0.00%, every baseline's
above 0, each gap to 1e-6 of JAX's), per-workload speedups and budgets,
arrivals, per-job (§7) policies, and the ``exhausted`` mask.  Then the
front door's refusals: K == M ambiguity, a budget mismatch, host
policies, bad shapes, and the M = 0 result.
"""
import logging

import numpy as np
import pytest
import torch

import repro.core as J
import repro.sched.policies as JP
import repro_torch.core as P
import repro_torch.core.simulator as P_sim
import repro_torch.sched.policies as PP
from repro.core.hesrpt import fit_power as fit_power_j
from torch_port_util import np_, port_speedup

B = 10.0
RTOL = 1e-6


def _match(res, ref, rtol=RTOL):
    assert res.policy_names == ref.policy_names
    np.testing.assert_allclose(np_(res.J), np.asarray(ref.J), rtol=rtol)
    np.testing.assert_allclose(np_(res.T), np.asarray(ref.T), rtol=rtol,
                               atol=rtol)
    assert np.array_equal(np_(res.n_events), np.asarray(ref.n_events))
    assert np.array_equal(np_(res.finished), np.asarray(ref.finished))
    assert np.array_equal(np_(res.exhausted), np.asarray(ref.exhausted))


def _gaps(J_):
    """The face-off table's columns: mean gap to SmartFill (row 0) in %,
    and the share of workloads that tie it."""
    gap = 100.0 * (J_ - J_[0]) / J_[0]
    return gap.mean(1), (J_ <= J_[0] * (1 + 1e-9)).mean(1)


def test_faceoff_zoo_matches_jax():
    """``examples/policy_faceoff.py``'s zoo and table at K = 16."""
    spj = J.log_speedup(1.0, 1.0, B)
    spt = port_speedup(spj)
    _, p_fit = fit_power_j(lambda t: float(np.log1p(t)), B)
    _, p_fit_t = P.fit_power(lambda t: np.log1p(t), B)
    assert p_fit_t == pytest.approx(p_fit, rel=1e-12)
    wl = J.sample_workloads(seed=0, K=16, M=8, B=B, m_range=(3, 8))
    ref = J.simulate_ensemble(spj, JP.default_zoo(spj, p_fit=p_fit), wl.X,
                              wl.W, B=B)
    res = P.simulate_ensemble(spt, PP.default_zoo(spt, p_fit=p_fit_t),
                              wl.X, wl.W, B=B)
    assert res.J.shape == (5, 16) and res.T.shape == (5, 16, 8)
    assert res.J.dtype == torch.float64 and len(res) == 5
    _match(res, ref)
    assert bool(res.finished.all()) and not bool(res.exhausted.any())
    gap, ties = _gaps(np_(res.J))
    gap_j, ties_j = _gaps(np.asarray(ref.J))
    np.testing.assert_allclose(gap, gap_j, atol=1e-6)
    assert np.array_equal(ties, ties_j)
    assert gap[0] == 0.0 and ties[0] == 1.0
    assert np.all(gap[1:] > 0.0)


def test_power_zoo_and_policy_ordering():
    """3 policies × 64 workloads, random agreeable weights: SmartFill ties
    heSRPT at the true p (≤ 1e-9) and both beat EQUI."""
    spj = J.power(1.0, 0.5, B)
    spt = port_speedup(spj)
    wl = J.sample_workloads(2, K=64, M=8, B=B, m_range=(2, 8),
                            weights="random")
    zoo_j = (JP.SmartFillPolicy(spj, B=B), JP.HeSRPTPolicy(p=0.5, B=B),
             JP.EquiPolicy(B))
    zoo_p = (PP.SmartFillPolicy(spt, B=B), PP.HeSRPTPolicy(p=0.5, B=B),
             PP.EquiPolicy(B))
    res = P.simulate_ensemble(spt, zoo_p, wl.X, wl.W, B=B)
    _match(res, J.simulate_ensemble(spj, zoo_j, wl.X, wl.W, B=B))
    J_ = np_(res.J)
    assert np.all(J_[0] <= J_[1] * (1 + 1e-9))
    assert np.all(J_[1] <= J_[2] * (1 + 1e-9))


def test_simulated_equals_predicted_J():
    """Simulated SmartFill J == the planner's J and J_linear (Prop. 9)."""
    spt = P.log_speedup(1.0, 1.0, B, device="cpu")
    wl = P.sample_workloads(1, K=16, M=6, B=B, m_range=(2, 6))
    planned = P.smartfill_batched(spt, wl.X, wl.W, B=B, active=wl.active)
    res = P.simulate_ensemble(spt, (PP.SmartFillPolicy(spt, B=B),), wl.X,
                              wl.W, B=B)
    np.testing.assert_allclose(np_(res.J[0]), np_(planned.J_linear),
                               rtol=RTOL)
    np.testing.assert_allclose(np_(res.J[0]), np_(planned.J), rtol=RTOL)


def test_per_workload_speedups_match_jax():
    wl = J.sample_workloads(4, K=8, M=5, B=B,
                            family=("power", "shifted", "log", "neg_power"))
    spt = port_speedup(wl.sp)
    assert spt.A.shape == (8,)
    ref = J.simulate_ensemble(wl.sp, (JP.SmartFillPolicy(wl.sp, B=B),
                                      JP.GWFStaticPolicy(wl.sp, B=B),
                                      JP.EquiPolicy(B)), wl.X, wl.W, B=B)
    res = P.simulate_ensemble(spt, (PP.SmartFillPolicy(spt, B=B),
                                    PP.GWFStaticPolicy(spt, B=B),
                                    PP.EquiPolicy(B)), wl.X, wl.W, B=B)
    _match(res, ref)
    J_ = np_(res.J)
    assert np.all(J_[0] <= J_[2] * (1 + 1e-9))


def test_per_job_policies_match_jax():
    """(K, M) per-job leaves (paper §7): heteroSF and WMR."""
    wl = J.sample_workloads(17, K=6, M=4, B=B,
                            family=("power", "log", "saturating"),
                            per_job=True)
    spt = port_speedup(wl.sp)
    ref = J.simulate_ensemble(
        wl.sp, (JP.HeteroSmartFillPolicy(wl.sp, B=B),
                JP.WeightedMarginalRatePolicy(wl.sp, B=B)), wl.X, wl.W, B=B)
    res = P.simulate_ensemble(
        spt, (PP.HeteroSmartFillPolicy(spt, B=B),
              PP.WeightedMarginalRatePolicy(spt, B=B)), wl.X, wl.W, B=B)
    _match(res, ref)
    assert np.mean(np_(res.J[0]) <= np_(res.J[1]) * (1 + 1e-9)) >= 0.5


def test_arrivals_and_per_workload_budgets():
    spj = J.power(1.0, 0.5, B)
    spt = port_speedup(spj)
    wl = J.sample_workloads(5, K=8, M=6, B=B, arrival_rate=0.5)
    assert (wl.arrival > 0).any()
    ref = J.simulate_ensemble(spj, (JP.HeSRPTPolicy(p=0.5, B=B),
                                    JP.SRPT1Policy(B)), wl.X, wl.W,
                              arrival=wl.arrival, B=B)
    res = P.simulate_ensemble(spt, (PP.HeSRPTPolicy(p=0.5, B=B),
                                    PP.SRPT1Policy(B)), wl.X, wl.W,
                              arrival=wl.arrival, B=B)
    _match(res, ref)
    K, M = 6, 4
    X = np.tile(np.arange(M, 0, -1.0), (K, 1))
    budgets = np.array([2.0, 4.0, 6.0, 8.0, 10.0, 12.0])
    res = P.simulate_ensemble(spt, (PP.EquiPolicy(B=budgets),), X, 1.0 / X)
    ref = J.simulate_ensemble(spj, (JP.EquiPolicy(B=budgets),), X, 1.0 / X)
    _match(res, ref)
    assert np.all(np.diff(np_(res.J[0])) < 0)


def test_exhausted_mask_and_warning(caplog):
    spt = P.power(1.0, 0.5, B, device="cpu")
    wl = P.sample_workloads(1, K=4, M=6, B=B, m_range=(6, 6))
    res = P.simulate_ensemble(spt, (PP.EquiPolicy(B),), wl.X, wl.W, B=B)
    assert res.exhausted.shape == res.J.shape
    assert not bool(res.exhausted.any())
    P_sim._warned_event_budget = False
    try:
        with caplog.at_level(logging.WARNING, logger=P_sim.__name__):
            starved = P.simulate_ensemble(spt, (PP.EquiPolicy(B),), wl.X,
                                          wl.W, B=B, n_events=2)
        ex, fin = np_(starved.exhausted), np_(starved.finished)
        assert ex.any() and np.array_equal(ex, ~fin)
        assert np.all(np_(starved.J)[ex] == np.inf)
        assert any("event budget" in r.message for r in caplog.records)
        ref = J.simulate_ensemble(J.power(1.0, 0.5, B), (JP.EquiPolicy(B),),
                                  wl.X, wl.W, B=B, n_events=2)
        _match(starved, ref)
        caplog.clear()
        with caplog.at_level(logging.WARNING, logger=P_sim.__name__):
            P.simulate_ensemble(spt, (PP.EquiPolicy(B),), wl.X, wl.W, B=B,
                                n_events=2)
        assert not any("event budget" in r.message for r in caplog.records)
    finally:
        P_sim._warned_event_budget = False


def test_front_door_refusals_and_empty_result():
    spt = P.power(1.0, 0.5, B, device="cpu")
    Km = 4
    X = np.tile(np.arange(Km, 0, -1.0), (Km, 1))
    with pytest.raises(ValueError, match="K == M"):
        P.simulate_ensemble(spt, (PP.EquiPolicy(B=np.full(Km, B)),), X,
                            1.0 / X)
    with pytest.raises(ValueError, match="K == M"):
        P.simulate_ensemble(P.RegularSpeedup(
            A=torch.full((Km,), 0.5, dtype=torch.float64),
            w=torch.zeros(Km, dtype=torch.float64),
            gamma=torch.full((Km,), -0.5, dtype=torch.float64), sigma=1,
            B=B), (PP.EquiPolicy(B),), X, 1.0 / X)
    # (K, 1) leaves disambiguate and broadcast per workload
    res = P.simulate_ensemble(spt, (PP.EquiPolicy(B=np.full((Km, 1), B)),),
                              X, 1.0 / X)
    assert bool(res.finished.all())
    with pytest.raises(ValueError, match="own budget"):
        P.simulate_ensemble(spt, (PP.EquiPolicy(B=5.0),), X, 1.0 / X, B=B)
    ones = np.ones((2, 3))
    with pytest.raises(ValueError, match="device-ready"):
        P.simulate_ensemble(spt, (lambda rem, w, a: rem,), ones, ones, B=B)
    with pytest.raises(ValueError, match=r"\(K, M\)"):
        P.simulate_ensemble(spt, (PP.EquiPolicy(B),), np.ones(3),
                            np.ones(3), B=B)
    with pytest.raises(ValueError, match="at least one"):
        P.simulate_ensemble(spt, (), ones, ones, B=B)
    with pytest.raises(ValueError, match="arrival"):
        P.simulate_ensemble(spt, (PP.EquiPolicy(B),), ones, ones,
                            arrival=np.zeros(3))
    empty = P.simulate_ensemble(spt, (PP.EquiPolicy(B), PP.SRPT1Policy(B)),
                                np.zeros((3, 0)), np.zeros((3, 0)))
    ref = J.simulate_ensemble(J.power(1.0, 0.5, B),
                              (JP.EquiPolicy(B), JP.SRPT1Policy(B)),
                              np.zeros((3, 0)), np.zeros((3, 0)))
    _match(empty, ref)
    assert empty.T.shape == (2, 3, 0)
