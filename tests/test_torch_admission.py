"""Port vs JAX: admission control (``serve/admission.py``).

Marginal-ΔJ scoring through one batched SmartFill call.  Every case
scores the same numpy running set and candidates in both packages; the
port's ΔJ and baseline J are held to the JAX package's at 1e-9 relative
(its plans agree with the reference's to ~1e-16 in J), and each of the
reference's own checks (sequential replanning at 1e-6, the simulated
estimator at 1e-6, the mixed-model estimator at 1e-4) is run on the
port.
"""
import numpy as np
import pytest

import repro.core as J
from repro.serve.admission import AdmissionController as JAdmission
import repro_torch.core as P
from repro_torch.serve.admission import AdmissionController
from torch_port_util import port_speedup

B = 10.0
DJ = 1e-9       # port vs JAX, relative, on ΔJ and the baseline J


def _sorted(x, w):
    order = np.lexsort((w, -x))
    return x[order], w[order]


@pytest.fixture(scope="module")
def sps():
    spj = J.log_speedup(1.0, 1.0, B)
    return spj, port_speedup(spj)


def _vs_jax(dec, ref):
    np.testing.assert_allclose(dec.marginal_cost, ref.marginal_cost,
                               rtol=DJ, atol=1e-12)
    assert dec.baseline_J == pytest.approx(ref.baseline_J, rel=DJ,
                                           abs=1e-12)
    np.testing.assert_array_equal(dec.admit, ref.admit)
    assert dec.status == ref.status == "ok"


def test_marginal_cost_matches_sequential_replanning(sps):
    spj, sp = sps
    running = np.array([8.0, 5.0, 2.0])
    r_w = 1.0 / running
    cands = np.array([6.0, 1.0])
    c_w = 1.0 / cands
    dec = AdmissionController(sp, B).evaluate(running, r_w, cands, c_w)
    _vs_jax(dec, JAdmission(spj, B).evaluate(running, r_w, cands, c_w))

    xs, ws = _sorted(running, r_w)
    J_base = P.smartfill(sp, xs, ws, B=B, validate=False).J
    assert abs(dec.baseline_J - J_base) / J_base < 1e-6
    for i in range(2):
        xs, ws = _sorted(np.append(running, cands[i]),
                         np.append(r_w, c_w[i]))
        J_i = P.smartfill(sp, xs, ws, B=B, validate=False).J
        assert abs(dec.marginal_cost[i] - (J_i - J_base)) < 1e-6 * J_i


def test_adding_work_never_helps(sps):
    spj, sp = sps
    rng = np.random.default_rng(0)
    running = np.sort(rng.uniform(1.0, 10.0, 5))[::-1]
    cands = rng.uniform(0.5, 10.0, 7)
    args = (running, 1.0 / running, cands, 1.0 / cands)
    dec = AdmissionController(sp, B).evaluate(*args)
    assert np.all(dec.marginal_cost > 0)
    _vs_jax(dec, JAdmission(spj, B).evaluate(*args))


def test_threshold_gates_admission(sps):
    spj, sp = sps
    running = np.array([5.0, 3.0])
    cands = np.array([0.5, 20.0])      # a tiny job and a huge job
    args = (running, 1.0 / running, cands, 1.0 / cands)
    dec = AdmissionController(sp, B, cost_threshold=np.inf).evaluate(*args)
    assert dec.admit.all()
    # a threshold between the two costs admits only the cheap one
    thr = float(np.sort(dec.marginal_cost).mean())
    dec2 = AdmissionController(sp, B, cost_threshold=thr).evaluate(*args)
    assert dec2.admit.sum() == 1
    assert dec2.admit[np.argmin(dec2.marginal_cost)]
    _vs_jax(dec2, JAdmission(spj, B, cost_threshold=thr).evaluate(*args))


def test_admit_best_ranks_by_marginal_cost(sps):
    spj, sp = sps
    running = np.array([5.0])
    cands = np.array([9.0, 0.5, 3.0])
    args = (running, 1.0 / running, cands, 1.0 / cands)
    ac = AdmissionController(sp, B)
    best = ac.admit_best(*args, k=2)
    dec = ac.evaluate(*args)
    assert list(best) == list(np.argsort(dec.marginal_cost, kind="stable")[:2])
    assert list(best) == list(JAdmission(spj, B).admit_best(*args, k=2))


def test_non_agreeable_weights_rejected(sps):
    """SmartFill's J is only optimal on agreeable instances — a mix where
    the bigger job has the bigger weight must raise, not silently rank;
    ``agreeable="rank"`` scores the SJF ranking's J, as the JAX
    package's does."""
    spj, sp = sps
    running = np.array([8.0, 5.0])
    r_w = np.array([5.0, 0.1])             # big job, big weight: not agreeable
    cands = np.array([2.0])
    with pytest.raises(ValueError, match="agreeable"):
        AdmissionController(sp, B).evaluate(running, r_w, cands,
                                            1.0 / cands)
    args = (running, r_w, cands, 1.0 / cands)
    _vs_jax(AdmissionController(sp, B, agreeable="rank").evaluate(*args),
            JAdmission(spj, B, agreeable="rank").evaluate(*args))
    with pytest.raises(ValueError, match="agreeable"):
        AdmissionController(sp, B, agreeable="sometimes")


def test_simulated_estimator_matches_planner(sps):
    """estimator='simulate' executes every mix on the scenario engine —
    by time consistency the ΔJ ranking equals the planner's ≤1e-6."""
    spj, sp = sps
    running = np.array([8.0, 5.0, 2.0])
    cands = np.array([6.0, 1.0, 3.5])
    args = (running, 1.0 / running, cands, 1.0 / cands)
    plan = AdmissionController(sp, B).evaluate(*args)
    sim = AdmissionController(sp, B, estimator="simulate").evaluate(*args)
    np.testing.assert_allclose(sim.marginal_cost, plan.marginal_cost,
                               rtol=1e-6, atol=1e-9)
    ref = JAdmission(spj, B, estimator="simulate").evaluate(*args)
    np.testing.assert_allclose(sim.marginal_cost, ref.marginal_cost,
                               rtol=1e-6, atol=1e-9)
    with pytest.raises(ValueError, match="estimator"):
        AdmissionController(sp, B, estimator="oracle")


def test_empty_edge_cases(sps):
    spj, sp = sps
    ac = AdmissionController(sp, B)
    dec = ac.evaluate(np.array([]), np.array([]), np.array([]), np.array([]))
    assert dec.baseline_J == 0.0 and dec.admit.shape == (0,)
    # empty running set: marginal cost is the candidate's standalone J
    cands = np.array([4.0])
    dec = ac.evaluate(np.array([]), np.array([]), cands, 1.0 / cands)
    J_solo = P.smartfill(sp, cands, 1.0 / cands, B=B, validate=False).J
    assert abs(dec.marginal_cost[0] - J_solo) < 1e-6 * J_solo
    _vs_jax(dec, JAdmission(spj, B).evaluate(np.array([]), np.array([]),
                                             cands, 1.0 / cands))


# ---------------------------------------------------------------------------
# Mixed-model admission (paper §7)
# ---------------------------------------------------------------------------

def test_mixed_model_scoring_defaults_match_shared(sps):
    """All-None speedup lists must reproduce the shared-function scores
    (the per-job path with every job on the controller's function)."""
    spj, sp = sps
    running = np.array([8.0, 5.0, 2.0])
    cands = np.array([4.0, 1.0])
    args = (running, 1.0 / running, cands, 1.0 / cands)
    kw = dict(running_speedups=[None] * 3, cand_speedups=[None] * 2)
    ac = AdmissionController(sp, B)
    a = ac.evaluate(*args)
    b = ac.evaluate(*args, **kw)
    np.testing.assert_allclose(b.marginal_cost, a.marginal_cost, rtol=1e-6)
    assert abs(b.baseline_J - a.baseline_J) / a.baseline_J < 1e-6
    _vs_jax(b, JAdmission(spj, B).evaluate(*args, **kw))
    # C = 0 keeps the baseline of the per-job path
    c = ac.evaluate(running, 1.0 / running, np.array([]), np.array([]),
                    running_speedups=[None] * 3)
    assert c.baseline_J == pytest.approx(b.baseline_J, rel=1e-12)


def test_mixed_model_scoring_discriminates_speedups(sps):
    """Two candidates with identical size/weight but different scaling
    curves must get different marginal costs — and the better-scaling
    one must be cheaper."""
    spj, sp = sps
    running = np.array([8.0, 5.0])
    cands = np.array([4.0, 4.0])
    args = (running, 1.0 / running, cands, 1.0 / cands)
    # candidate 0 scales ~√θ; candidate 1 saturates hard (θ/(θ+1))
    mk = [(J.power, (1.0, 0.5, B)), (J.neg_power, (1.0, 1.0, -1.0, B))]
    dec = AdmissionController(sp, B).evaluate(
        *args, running_speedups=None,
        cand_speedups=[port_speedup(f(*a)) for f, a in mk])
    assert np.isfinite(dec.marginal_cost).all()
    assert dec.marginal_cost[0] != dec.marginal_cost[1]
    assert dec.marginal_cost[0] < dec.marginal_cost[1]
    _vs_jax(dec, JAdmission(spj, B).evaluate(
        *args, running_speedups=None, cand_speedups=[f(*a) for f, a in mk]))


def test_mixed_model_simulated_estimator_agrees(sps):
    spj, sp = sps
    running = np.array([8.0, 5.0])
    cands = np.array([4.0, 1.0])
    args = (running, 1.0 / running, cands, 1.0 / cands)
    run_j, cand_j = [J.power(1.0, 0.6, B), None], \
        [J.neg_power(1.0, 2.0, -1.0, B), None]
    kw = dict(running_speedups=[port_speedup(run_j[0]), None],
              cand_speedups=[port_speedup(cand_j[0]), None])
    plan = AdmissionController(sp, B).evaluate(*args, **kw)
    sim = AdmissionController(sp, B, estimator="simulate").evaluate(*args,
                                                                     **kw)
    np.testing.assert_allclose(sim.marginal_cost, plan.marginal_cost,
                               rtol=1e-4, atol=1e-7)
    _vs_jax(plan, JAdmission(spj, B).evaluate(
        *args, running_speedups=run_j, cand_speedups=cand_j))


def test_mixed_model_rejects_unstackable(sps):
    import torch

    _, sp = sps
    running = np.array([8.0])
    cands = np.array([4.0])
    gen = P.GenericSpeedup(s_fn=torch.log1p,
                           ds_fn=lambda t: 1.0 / (1.0 + t), B=B)
    with pytest.raises(TypeError, match="mixed-model"):
        AdmissionController(sp, B).evaluate(
            running, np.array([1.0]), cands, np.array([0.5]),
            cand_speedups=[gen])
