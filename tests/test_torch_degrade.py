"""Port vs JAX: the degradation ladder (``robust/degrade.py``).

The contract under forced solver failure (``SaboteurPolicy`` corrupting
the primary rung): the executed allocation is always finite,
non-negative and within the *live* budget B(t); where the primary's
certificate passes, the wrapped run is bit-identical to the unwrapped
policy.  Each case runs the same numpy instance through both packages
and holds the port's J, T and event trace to the JAX package's at the
reference's RTOL (1e-6); the port's own contracts (bit-identity with its
unwrapped primary, rung selection per lane) are checked exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.robust as JR
import repro.sched.policies as JP
import repro_torch.core as P
import repro_torch.robust as PR
import repro_torch.sched.policies as PP
from repro.core.simulator import budget_trace as budget_trace_j
from torch_port_util import assert_sim_match, np_, port_speedup, t64

B = 8.0
SPJ = J.power(1.0, 0.5, B)
SPT = port_speedup(SPJ)
X = np.array([5.0, 3.0, 1.0])
W = 1.0 / X


def _ladders(primary=None):
    """The canonical ladder in both packages; ``primary`` builds the
    first rung from (module, speedup)."""
    pj = None if primary is None else primary(JP, SPJ)
    pt = None if primary is None else primary(PP, SPT)
    return (JR.DegradingPolicy.ladder(SPJ, B=B, primary=pj),
            PR.DegradingPolicy.ladder(SPT, B=B, primary=pt))


def _sabotaged(mode, rungs=("gwf", "equi"), min_active=0):
    """(jax, port) ladders whose primary is SmartFill under sabotage."""
    out = []
    for mod, R, sp in ((JP, JR, SPJ), (PP, PR, SPT)):
        lower = {"gwf": mod.GWFStaticPolicy(sp, B=B),
                 "equi": mod.EquiPolicy(B)}
        sab = R.SaboteurPolicy(mod.SmartFillPolicy(sp, B=B), mode=mode,
                               min_active=min_active)
        out.append(R.DegradingPolicy(rungs=(sab,) + tuple(lower[r]
                                                          for r in rungs)))
    return out


def test_healthy_run_bit_identical_to_unwrapped():
    plain = P.simulate_policy_device(SPT, X, W, PP.SmartFillPolicy(SPT, B=B))
    lad_j, lad = _ladders()
    wrapped = P.simulate_policy_device(SPT, X, W, lad)
    assert wrapped.J == plain.J                       # bitwise, not approx
    np.testing.assert_array_equal(wrapped.T, plain.T)
    assert wrapped.n_events == plain.n_events
    for (t0, th0), (t1, th1) in zip(plain.events, wrapped.events):
        assert t0 == t1
        np.testing.assert_array_equal(th0, th1)
    assert_sim_match(wrapped, J.simulate_policy_device(SPJ, X, W, lad_j),
                     B=B)


@pytest.mark.parametrize("mode", ["nan", "overspend", "negative"])
def test_sabotaged_primary_falls_to_gwf(mode):
    lad_j, lad = _sabotaged(mode)
    gwf = P.simulate_policy_device(SPT, X, W, PP.GWFStaticPolicy(SPT, B=B))
    res = P.simulate_policy_device(SPT, X, W, lad)
    assert res.J == gwf.J                             # rung 1 exactly
    for _, th in res.events:
        assert np.all(np.isfinite(th))
        assert np.all(th >= 0)
        assert th.sum() <= B * (1 + 1e-6)
    assert_sim_match(res, J.simulate_policy_device(SPJ, X, W, lad_j), B=B)


def test_all_rungs_sabotaged_emits_zero_allocation():
    lad_j, lad = _ladders()
    rungs = tuple(PR.SaboteurPolicy(r, mode="nan") for r in lad.rungs)
    rungs_j = tuple(JR.SaboteurPolicy(r, mode="nan") for r in lad_j.rungs)
    all_bad = PR.DegradingPolicy(rungs=rungs)
    all_bad_j = JR.DegradingPolicy(rungs=rungs_j)
    rem, w, active = t64(X), t64(W), torch.ones(3, dtype=torch.bool)
    th = all_bad(rem, w, active)
    np.testing.assert_array_equal(np_(th), np.zeros(3))
    np.testing.assert_array_equal(
        np_(th), np.asarray(all_bad_j(jnp.asarray(X), jnp.asarray(W),
                                      jnp.ones(3, bool))))
    idx = all_bad.rung_index(rem, w, active)
    assert idx.ndim == 0 and int(idx) == len(rungs)
    assert int(all_bad_j.rung_index(jnp.asarray(X), jnp.asarray(W),
                                    jnp.ones(3, bool))) == len(rungs)


def test_respects_dynamic_budget():
    """After a budget-drop fault the ladder's certificate gates against
    B(t), not the construction-time budget."""
    lad_j, lad = _sabotaged("overspend")
    tr = P.budget_trace([1.0], [2.0])                 # B: 8 -> 2 at t = 1
    res = P.simulate_policy_device(SPT, X, W, lad, faults=tr)
    assert np.isfinite(res.J)
    for t, th in res.events:
        cap = 2.0 if t >= 1.0 else B
        assert th.sum() <= cap * (1 + 1e-6), (t, th)
    ref = J.simulate_policy_device(SPJ, X, W, lad_j,
                                   faults=budget_trace_j([1.0], [2.0]))
    assert_sim_match(res, ref, B=B)


def test_rung_index_reports_selection():
    lad_j, lad = _ladders()
    rem, w, act = t64(X), t64(W), torch.ones(3, dtype=torch.bool)
    assert int(lad.rung_index(rem, w, act)) == 0
    sab_j, sab = _sabotaged("nan")
    assert int(sab.rung_index(rem, w, act)) == 1
    assert int(sab_j.rung_index(jnp.asarray(X), jnp.asarray(W),
                                jnp.ones(3, bool))) == 1


def test_rung_selection_is_per_lane():
    """Batch-first: a (K, M) call selects a rung for each workload on
    its own — lanes over ``min_active`` fall to GWF-static, the others
    keep their primary's allocation bit for bit."""
    _, sab = _sabotaged("nan", min_active=2)
    REM = t64(np.array([[5.0, 3.0, 1.0], [5.0, 3.0, 0.0], [4.0, 2.0, 1.0]]))
    Wt = torch.where(REM > 0, 1.0 / torch.where(REM > 0, REM, 1.0), 0.0)
    act = REM > 0
    idx = sab.rung_index(REM, Wt, act)
    assert idx.tolist() == [1, 0, 1]
    th = sab(REM, Wt, act)
    primary = PP.SmartFillPolicy(SPT, B=B)(REM, Wt, act)
    gwf = PP.GWFStaticPolicy(SPT, B=B)(REM, Wt, act)
    assert torch.equal(th[1], primary[1])
    assert torch.equal(th[0], gwf[0]) and torch.equal(th[2], gwf[2])


def test_min_active_mixes_rungs_along_trajectory():
    """Sabotage only while > 1 job is active: the run starts on the
    fallback rung and finishes on the (healthy) primary."""
    lad_j, lad = _sabotaged("nan", rungs=("equi",), min_active=1)
    rep = PR.degradation_report(SPT, X, W, lad, B=B)
    ref = JR.degradation_report(SPJ, X, W, lad_j, B=B)
    assert np.isfinite(rep["J"])
    assert rep["rung_counts"].get(1, 0) > 0           # degraded early
    assert rep["rung_counts"].get(0, 0) > 0           # primary endgame
    assert rep["rung_counts"] == ref["rung_counts"]
    assert rep["n_events"] == ref["n_events"]
    assert abs(rep["J"] - ref["J"]) <= 1e-6 * ref["J"]


def test_degradation_report_healthy_is_all_primary():
    lad_j, lad = _ladders()
    rep = PR.degradation_report(SPT, X, W, lad, B=B)
    assert set(rep["rung_counts"]) == {0}
    plain = P.simulate_policy_device(SPT, X, W, PP.SmartFillPolicy(SPT, B=B))
    assert abs(rep["J"] - plain.J) < 1e-9
    ref = JR.degradation_report(SPJ, X, W, lad_j, B=B)
    assert rep["rung_counts"] == ref["rung_counts"]
    np.testing.assert_allclose(rep["T"], ref["T"], rtol=1e-6)


def test_ladder_binds_every_rung():
    """``bind`` reaches the rungs and the saboteur's inner policy, and
    the ladder's budget is its primary's."""
    lad = PR.DegradingPolicy(rungs=(
        PR.SaboteurPolicy(PP.SmartFillPolicy(SPT, B=B), mode="nan"),
        PP.EquiPolicy(B=np.full(4, B))))
    bound = lad.bind("cpu", torch.float32)
    assert bound.rungs[0].inner.B.dtype == torch.float32
    assert bound.rungs[0].inner.sp.A.dtype == torch.float32
    assert bound.rungs[1].B.shape == (4,)
    assert bound.B is bound.rungs[0].B


def test_ladder_plan_table_matches_jax():
    """The (M, M) table built from one policy call over the M prefixes
    equals the JAX package's vmapped table; a healthy SmartFill ladder's
    table is the SmartFill plan's Θ."""
    lad_j, lad = _ladders()
    tab = PR.ladder_plan_table(lad, t64(X), t64(W))
    ref = JR.ladder_plan_table(lad_j, jnp.asarray(X), jnp.asarray(W))
    np.testing.assert_allclose(np_(tab), np.asarray(ref), atol=1e-9)
    plan = P.smartfill(SPT, X, W, B=B)
    np.testing.assert_allclose(np_(tab), np_(plan.theta), atol=1e-9)
    _, sab = _sabotaged("nan")
    tab = PR.ladder_plan_table(sab, t64(X), t64(W))
    assert bool(torch.isfinite(tab).all())
    assert bool((tab.sum(0) <= B * (1 + 1e-6)).all())


def test_empty_ladder_rejected():
    with pytest.raises(ValueError, match="at least one rung"):
        PR.DegradingPolicy(rungs=())
    with pytest.raises(ValueError, match="mode"):
        PR.SaboteurPolicy(PP.EquiPolicy(B), mode="garbage")
