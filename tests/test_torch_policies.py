"""Port vs JAX: the policy zoo's allocations on the same state.

Each port policy is called batch-first on (K, M) (rem, w, active) — with
per-workload leaves (budgets, exponents, speedup parameters) of leading
dimension K — and held against the JAX policy called per instance on
that instance's row and leaves.  Allocations agree to the simulator
tests' event tolerance, 1e-6·B (SmartFill off the pure-power path
places μ* at a flat minimum; see ``test_torch_smartfill.py``); EQUI,
SRPT-1 and heSRPT to 1e-12·B.  Then the live-budget argument, the empty
active set, ``default_zoo``'s contents, heteroSF against SmartFill on a
shared speedup (T to 1e-9), and the cached plan: executed verbatim
while the budget stands, re-solved where it moves (J to 1e-6 against
the JAX host oracle).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.sched.policies as JP
import repro_torch.core as P
import repro_torch.sched.policies as PP
from torch_port_util import np_, port_speedup, t64

B = 10.0
K, M = 6, 5


def _state(seed=0):
    """(rem, w, active) with ties in rem (row 1), an empty row (3), a
    full row (4) and inactive slots elsewhere."""
    rng = np.random.default_rng(seed)
    rem = rng.uniform(0.5, 10.0, (K, M))
    w = rng.uniform(0.1, 2.0, (K, M))
    rem[1, 2] = rem[1, 3] = rem[1, 4] = rem[1, 0]
    w[1, 3] = w[1, 0]
    active = rng.uniform(size=(K, M)) < 0.7
    active[1, [0, 2, 3, 4]] = True
    active[3] = False
    active[4] = True
    return rem, w, active


# one compile per policy structure: the JAX policies are called with an
# explicit budget, their own B for the 3-argument form (the reference's
# test_policies_respect_live_budget_argument pins the two as equal)
_call_b = jax.jit(lambda pol, r, w, a, b: pol(r, w, a, b))


def _lane(tree, k):
    return jax.tree_util.tree_map(
        lambda l: l[k] if np.ndim(l) >= 1 else l, tree)


def _jax_rows(pol_j, rem, w, active, per_lane=True, b=None):
    rows = []
    for k in range(K):
        pk = _lane(pol_j, k) if per_lane else pol_j
        rows.append(np.asarray(_call_b(
            pk, jnp.asarray(rem[k]), jnp.asarray(w[k]),
            jnp.asarray(active[k]),
            jnp.asarray(pk.B if b is None else b[k], jnp.float64))))
    return np.stack(rows)


def _per_workload_sp(fams, seed=4):
    wl = J.sample_workloads(seed, K=K, M=M, B=B, family=fams)
    return wl.sp, port_speedup(wl.sp)


def _per_job_sp(fams, seed=17):
    wl = J.sample_workloads(seed, K=K, M=M, B=B, family=fams, per_job=True)
    return wl.sp, port_speedup(wl.sp)


BUDGETS = np.array([2.0, 4.0, 6.0, 8.0, 12.0, 10.0])
PS = np.array([0.3, 0.45, 0.5, 0.7, 0.85, 0.6])


def _cases():
    log_j = J.log_speedup(1.0, 1.0, B)
    pow_j = J.power(1.0, 0.5, B)
    mixj, mixp = _per_workload_sp(("power", "shifted", "log", "saturating"))
    pjj, pjp = _per_job_sp(("power", "log", "saturating"))
    c = np.linspace(1.0, 0.2, M)
    return {
        # name: (JAX policy with (K,) leaves, port policy, per_lane, atol/B)
        "equi_budgets": (JP.EquiPolicy(B=BUDGETS), PP.EquiPolicy(B=BUDGETS),
                         True, 1e-12),
        "srpt1_budgets": (JP.SRPT1Policy(B=BUDGETS),
                          PP.SRPT1Policy(B=BUDGETS), True, 1e-12),
        "hesrpt_exponents": (JP.HeSRPTPolicy(p=PS, B=B),
                             PP.HeSRPTPolicy(p=PS, B=B), True, 1e-12),
        "smartfill_power": (JP.SmartFillPolicy(pow_j, B=B),
                            PP.SmartFillPolicy(port_speedup(pow_j), B=B),
                            False, 1e-9),
        "smartfill_log": (JP.SmartFillPolicy(log_j, B=B),
                          PP.SmartFillPolicy(port_speedup(log_j), B=B),
                          False, 1e-6),
        "smartfill_per_workload": (JP.SmartFillPolicy(mixj, B=B),
                                   PP.SmartFillPolicy(mixp, B=B), True, 1e-6),
        "gwfstatic_log": (JP.GWFStaticPolicy(log_j, B=B),
                          PP.GWFStaticPolicy(port_speedup(log_j), B=B),
                          False, 1e-9),
        "gwfstatic_per_workload": (JP.GWFStaticPolicy(mixj, B=B),
                                   PP.GWFStaticPolicy(mixp, B=B), True, 1e-9),
        "gwfstatic_constants": (JP.GWFStaticPolicy(log_j, B=B, c=c),
                                PP.GWFStaticPolicy(port_speedup(log_j), B=B,
                                                   c=c), False, 1e-9),
        "wmr_per_job": (JP.WeightedMarginalRatePolicy(pjj, B=B),
                        PP.WeightedMarginalRatePolicy(pjp, B=B), True, 1e-9),
        "wmr_shared": (JP.WeightedMarginalRatePolicy(log_j, B=B),
                       PP.WeightedMarginalRatePolicy(port_speedup(log_j),
                                                     B=B), False, 1e-9),
        "heterosf_per_job": (JP.HeteroSmartFillPolicy(pjj, B=B),
                             PP.HeteroSmartFillPolicy(pjp, B=B), True, 1e-6),
    }


CASES = list(_cases())


@pytest.mark.parametrize("case", CASES)
def test_allocations_match_jax_per_instance(case):
    pol_j, pol_p, per_lane, tol = _cases()[case]
    rem, w, active = _state()
    out = pol_p(t64(rem), t64(w), t64(active))
    assert out.shape == (K, M) and out.dtype == torch.float64
    ref = _jax_rows(pol_j, rem, w, active, per_lane)
    np.testing.assert_allclose(np_(out), ref, atol=tol * B, rtol=0)
    th = np_(out)
    assert np.all(th[~active] == 0.0) and np.all(th >= 0.0)
    assert np.all(th[3] == 0.0) and np.all(np.isfinite(th))
    # the live-budget argument: B(t) per workload
    bt = np.array([1.0, 2.5, 5.0, 7.5, 9.0, 12.0])
    out_b = pol_p(t64(rem), t64(w), t64(active), t64(bt))
    ref_b = _jax_rows(pol_j, rem, w, active, per_lane, b=bt)
    np.testing.assert_allclose(np_(out_b), ref_b, atol=tol * B, rtol=0)
    assert np.all(np_(out_b).sum(1) <= bt * (1 + 1e-9))
    if not per_lane:                    # one (M,) workload: the K = 1 call
        one = pol_p(t64(rem[4]), t64(w[4]), t64(active[4]))
        np.testing.assert_allclose(np_(one), th[4], atol=1e-12 * B, rtol=0)


@pytest.mark.parametrize("fam", ["power", "log"])
def test_live_budget_overrides_own_budget(fam):
    spj = {"power": J.power(1.0, 0.5, B), "log": J.log_speedup(1.0, 1.0, B)}[fam]
    spt = port_speedup(spj)
    rem = t64([[6.0, 3.0, 1.0]])
    w = 1.0 / rem
    active = torch.ones((1, 3), dtype=torch.bool)
    for pol in PP.default_zoo(spt, p_fit=0.5):
        low = np_(pol(rem, w, active, 2.5))
        assert low.sum() <= 2.5 * (1 + 1e-6), pol.name
        np.testing.assert_allclose(np_(pol(rem, w, active, B)),
                                   np_(pol(rem, w, active)), rtol=1e-12)


def test_empty_active_set_and_zoo_contents():
    spt = P.log_speedup(1.0, 1.0, B, device="cpu")
    zoo = PP.default_zoo(spt, p_fit=0.48)
    assert [p.name for p in zoo] == [p.name for p in JP.default_zoo(
        J.log_speedup(1.0, 1.0, B), p_fit=0.48)]
    assert [type(p).__name__ for p in zoo] == [
        "SmartFillPolicy", "HeSRPTPolicy", "EquiPolicy", "SRPT1Policy",
        "GWFStaticPolicy"]
    assert zoo[1].p == 0.48 and all(p.B == B for p in zoo)
    assert all(p.device_ready for p in zoo) and zoo[0].fast is False
    assert PP.SmartFillPolicy(P.power(1.0, 0.5, B, device="cpu"), B).fast
    rem = t64(np.arange(5, 0, -1.0)[None].repeat(2, 0))
    none = torch.zeros((2, 5), dtype=torch.bool)
    for pol in zoo:
        th = pol(rem, 1.0 / rem, none)
        assert bool((th == 0.0).all()) and bool(torch.isfinite(th).all())


def test_tied_sizes_rank_as_jax_lexsort():
    """Equal remaining sizes: the order (and heSRPT's unequal shares on
    it) follows the weights, then the slot index, as jnp.lexsort."""
    rem = np.array([4.0, 2.0, 4.0, 4.0, 1.0, 2.0])
    w = np.array([0.5, 0.3, 0.2, 0.5, 1.0, 0.3])
    act = np.ones(6, bool)
    order_p = np_(PP._active_order(t64(rem)[None], t64(w)[None],
                                   t64(act)[None]))[0]
    order_j = np.asarray(JP._active_order(jnp.asarray(rem), jnp.asarray(w),
                                          jnp.asarray(act)))
    assert np.array_equal(order_p, order_j)
    th = np_(PP.HeSRPTPolicy(0.5, B)(t64(rem), t64(w), t64(act)))
    th_j = np.asarray(JP.HeSRPTPolicy(0.5, B)(jnp.asarray(rem),
                                              jnp.asarray(w),
                                              jnp.asarray(act)))
    np.testing.assert_allclose(th, th_j, rtol=0, atol=1e-12 * B)


def test_heterosf_equals_smartfill_on_a_shared_speedup():
    spt = P.log_speedup(1.0, 1.0, B, device="cpu")
    x = np.arange(6, 0, -1.0)
    w = 1.0 / x
    a = P.simulate_policy_device(spt, x, w, PP.SmartFillPolicy(spt, B=B),
                                 B=B)
    b = P.simulate_policy_device(spt, x, w,
                                 PP.HeteroSmartFillPolicy(spt, B=B), B=B)
    np.testing.assert_allclose(b.T, a.T, rtol=1e-9)


def _hetero_instance(seed=3, m=5):
    rng = np.random.default_rng(seed)
    st = J.stack_speedups([J.power(1.0, p, B)
                           for p in rng.uniform(0.3, 0.9, m)])
    x = np.sort(rng.uniform(1.0, 8.0, m))[::-1].copy()
    return st, port_speedup(st), x, 1.0 / x


@pytest.fixture(scope="module")
def cached():
    stj, stp, x, w = _hetero_instance()
    # the heuristic order (the exchange search is test_torch_hetero's)
    pol_j = JP.HeteroSmartFillPolicy.pinned(stj, x, w, B=B, cache_plan=True,
                                            exchange_passes=0)
    pol_p = PP.HeteroSmartFillPolicy.pinned(stp, x, w, B=B, cache_plan=True,
                                            exchange_passes=0)
    return stj, stp, x, w, pol_j, pol_p


def test_pinned_plan_matches_jax(cached):
    stj, stp, x, w, pol_j, pol_p = cached
    assert np.array_equal(np_(pol_p.rank), np.asarray(pol_j.rank))
    np.testing.assert_allclose(np_(pol_p.theta), np.asarray(pol_j.theta),
                               atol=1e-6 * B, rtol=0)
    out = P.simulate_policy_device(stp, x, w, pol_p, B=B)
    ref = J.simulate_policy_device(stj, x, w, pol_j, B=B)
    assert abs(out.J - ref.J) / ref.J < 1e-6 and out.n_events == ref.n_events
    # in the searched order, which the recursion realizes (J == J_linear),
    # the cached table executes the one-shot plan (Prop. 7)
    plan = P.smartfill_hetero(stp, x, w, B=B)
    assert abs(plan.J - plan.J_linear) / plan.J < 1e-9
    searched = PP.HeteroSmartFillPolicy.pinned(stp, x, w, B=B,
                                               cache_plan=True)
    out = P.simulate_policy_device(stp, x, w, searched, B=B)
    assert abs(out.J - plan.J) / plan.J < 1e-6
    with pytest.raises(ValueError, match="cache_plan"):
        PP.HeteroSmartFillPolicy.pinned(stp, x, w, B=B, order=np.arange(5),
                                        cache_plan=True)


def test_cached_plan_noop_budget_event_executes_table_verbatim(cached):
    """A budget event that re-asserts the construction budget leaves the
    table executing verbatim: every faulted event's allocations are a
    plain event's, bit for bit."""
    _, stp, x, w, _, pol_p = cached
    plain = P.simulate_policy_device(stp, x, w, pol_p, B=B)
    noop = P.simulate_policy_device(stp, x, w, pol_p, B=B,
                                    faults=P.budget_trace([0.5], [B]))
    assert abs(noop.J - plain.J) <= 1e-12 * plain.J
    np.testing.assert_allclose(noop.T, plain.T, rtol=1e-12)
    plain_th = {th.tobytes() for _, th in plain.events}
    for _, th in noop.events:
        assert th.tobytes() in plain_th


def test_cached_plan_invalidates_on_budget_change(cached):
    """The moment B(t) moves, the cached table re-solves on the pinned
    order: port engine == port oracle == JAX oracle, no event overspends
    B(t), and the drop changes the trajectory."""
    stj, stp, x, w, pol_j, pol_p = cached
    tr_p = P.budget_trace([0.4, 1.8], [B / 2, B])
    tr_j = J.budget_trace([0.4, 1.8], [B / 2, B])
    out = P.simulate_policy_device(stp, x, w, pol_p, B=B, faults=tr_p)
    ref = J.simulate_policy_reference(
        stj, x, w, lambda r, ww, a, b=None: np.asarray(
            _call_b(pol_j, r, ww, a, B if b is None else b)),
        B=B, faults=tr_j)
    ref_p = P.simulate_policy_reference(stp, x, w, pol_p, B=B, faults=tr_p)
    assert np.isfinite(ref.J)
    for r in (out, ref_p):
        assert abs(r.J - ref.J) / ref.J < 1e-6
        assert r.n_events == ref.n_events
    for t, th in out.events:
        cap = B / 2 if 0.4 <= t < 1.8 else B
        assert th.sum() <= cap * (1 + 1e-6), (t, th.sum())
    plain = P.simulate_policy_device(stp, x, w, pol_p, B=B)
    assert out.J > plain.J * (1 + 1e-6)


def test_batched_cached_plan_resolves_only_moved_workloads(cached):
    """One workload's budget drops; the others execute their tables
    verbatim, so their J is bit for bit the undisturbed run's.  The
    moved workload is held to the JAX host oracle running the same
    pinned plan."""
    Kb, Mb = 3, 5
    wl = P.sample_workloads(11, K=Kb, M=Mb, B=B, family=("power",
                                                         "saturating"),
                            per_job=True, device="cpu")
    pol_p = PP.HeteroSmartFillPolicy.pinned(wl.sp, wl.X, wl.W, B=B,
                                            cache_plan=True)
    for k in range(Kb):                 # the batched planner's order
        sp_k = J.StackedSpeedup(*(np_(getattr(wl.sp, n)[k]) for n in
                                  ("A", "w", "gamma", "sigma")), B=B)
        order = J.normalized_order(sp_k, wl.X[k], wl.W[k], B=B)
        assert np.array_equal(np.argsort(np_(pol_p.rank[k])), order)
    times = np.array([[0.3], [np.inf], [np.inf]])
    tr = P.FaultTrace(times, np.zeros((3, 1)), np.zeros((3, 1)),
                      np.full((3, 1), B / 3))
    plain = P.simulate_ensemble(wl.sp, (pol_p,), wl.X, wl.W, device="cpu")
    moved = P.simulate_ensemble(wl.sp, (pol_p,), wl.X, wl.W, faults=tr,
                                device="cpu")
    assert torch.equal(moved.J[0, 1:], plain.J[0, 1:])
    assert float(moved.J[0, 0]) > float(plain.J[0, 0]) * (1 + 1e-6)
    pol_j = JP.HeteroSmartFillPolicy(
        J.StackedSpeedup(*(np_(getattr(wl.sp, n)[0]) for n in
                           ("A", "w", "gamma", "sigma")), B=B), B=B,
        rank=jnp.asarray(np_(pol_p.rank[0])),
        theta=jnp.asarray(np_(pol_p.theta[0])))
    ref = J.simulate_policy_reference(
        J.StackedSpeedup(*(np_(getattr(wl.sp, n)[0]) for n in
                           ("A", "w", "gamma", "sigma")), B=B),
        wl.X[0], wl.W[0], lambda r, ww, a, b=None: np.asarray(
            _call_b(pol_j, r, ww, a, B if b is None else b)),
        B=B, faults=J.FaultTrace(times[0], tr.kinds[0], tr.jobs[0],
                                 tr.values[0]))
    assert abs(float(moved.J[0, 0]) - ref.J) / ref.J < 1e-6
    assert int(moved.n_events[0, 0]) == ref.n_events


def test_class_policy_from_classes_matches_jax():
    """``ClassSmartFillPolicy.from_classes``: the aggregate speedup, the
    pinned rank (empty classes ranked C) and the cached table equal to
    the JAX package's (the table to the pinned plan's 1e-6·B: μ* sits at
    a flat minimum); ``pin=False`` keeps the re-ranking policy; a policy
    built from a plan already made is the same policy."""
    rng = np.random.default_rng(3)
    C = 5
    spj = J.stack_speedups([J.log_speedup(1.0, 1.0, B),
                            J.saturating(1.2, 18.0, 1.6, B),
                            J.shifted_power(0.9, 2.0, 0.5, B),
                            J.power(1.1, 0.7, B),
                            J.neg_power(1.0, 2.5, -1.3, B)])
    counts = np.array([12.0, 0.0, 40.0, 3.0, 25.0])
    kw = dict(counts=counts, sizes=rng.uniform(0.5, 20.0, C),
              weights=rng.uniform(0.1, 5.0, C), B=B)
    sj = J.ClassState(sp=spj, **kw)
    st = P.ClassState(sp=port_speedup(spj), **kw)
    for pin, cache in ((True, True), (True, False), (False, False)):
        ref = JP.ClassSmartFillPolicy.from_classes(sj, pin=pin,
                                                   cache_plan=cache)
        out = PP.ClassSmartFillPolicy.from_classes(st, pin=pin,
                                                   cache_plan=cache)
        assert out.name == ref.name == "classSF"
        for name in ("A", "w", "gamma"):
            np.testing.assert_allclose(np_(getattr(out.sp, name)),
                                       np.asarray(getattr(ref.sp, name)),
                                       rtol=1e-15)
        if ref.rank is None:
            assert out.rank is None and out.theta is None
            continue
        assert np.array_equal(np_(out.rank), np.asarray(ref.rank))
        assert float(out.rank[1]) == C          # the empty class
        if cache:
            np.testing.assert_allclose(np_(out.theta), np.asarray(ref.theta),
                                       atol=1e-6 * B, rtol=0)
            assert np.all(np_(out.theta)[4:, :] == 0.0)
        else:
            assert out.theta is None
    plan = P.plan_classes(st)
    again = PP.ClassSmartFillPolicy._from_plan(st, plan, cache_plan=True)
    built = PP.ClassSmartFillPolicy.from_classes(st, cache_plan=True)
    assert torch.equal(again.rank, built.rank)
    assert torch.equal(again.theta, built.theta)
