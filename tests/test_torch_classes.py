"""Port vs JAX: class-aggregated planning (``core/classes.py``).

The same numpy inputs, made from a seed, go through the JAX package's
class layer and the port's (``device="cpu"``, float64), at the
reference's own tolerances (``tests/core/test_classes.py``):

  * ``class_speedup`` on every family, shared and per-class leaves, to
    1e-15, the identity bit for bit at n = 1, ``TypeError`` on a generic
    speedup; ``aggregate_classes``/``expand_classes`` equal to JAX;
  * ``plan_classes`` on the reference's seeded mixed σ = ±1 states (C
    2–6, counts 0–50) and on a C = 12 million-scale state: the same
    orders, J and J_linear to 1e-9 where the order is realized (J ==
    J_linear) and J to 1e-6 elsewhere, T to rtol 1e-6, atol 1e-9;
  * in the port: ``plan_classes`` equal to ``smartfill_hetero`` with the
    class knobs bit for bit at one job per class, the plan against the
    port's numpy oracle to 1e-8, and the port's oracle equal to the
    reference's bit for bit;
  * zero-count classes inert (1e-12), an all-empty state a no-op;
  * ``plan_classes_batched`` against the single-instance planner and the
    JAX batched call, ``compact_aggregate_batch`` equal to JAX's.

JAX compiles ``smartfill_hetero`` once per live-class count; the states
here take a few counts only.
"""
import functools

import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as P
from repro.core import classes as JC
from repro_torch.core.speedup import map_leaves
from torch_port_util import np_, port_speedup

B = 10.0
EXACT = 1e-9
ORACLE = 1e-6
CLASS_KNOBS = dict(coarse=64, descent_iters=96, cap_iters=64,
                   exchange_passes=2, exchange_window=1, stol_rel=1e-10)


def _rand_member(rng):
    f = rng.integers(0, 5)
    a = rng.uniform(0.5, 2.0)
    p = rng.uniform(0.3, 0.9)
    z = rng.uniform(0.5, 6.0)
    if f == 0:
        return J.power(a, p, B)
    if f == 1:
        return J.shifted_power(a, z, p, B)
    if f == 2:
        return J.log_speedup(a, rng.uniform(0.3, 2.0), B)
    if f == 3:
        return J.neg_power(a, z, -rng.uniform(0.5, 2.0), B)
    return J.saturating(a, rng.uniform(1.2 * B, 3.0 * B),
                        rng.uniform(1.2, 2.5), B)


def _rand_state(rng, C=None, count_range=(0, 50)):
    """The reference's state: mixed σ = ±1 families, zero counts in the
    mix.  Returns (JAX ClassState, port ClassState)."""
    C = int(rng.integers(2, 7)) if C is None else C
    sp = J.stack_speedups([_rand_member(rng) for _ in range(C)])
    lo, hi = count_range
    counts = rng.integers(lo, hi + 1, C).astype(np.float64)
    if not (counts > 0).any():
        counts[rng.integers(0, C)] = 1.0
    sizes = rng.uniform(0.5, 20.0, C)
    weights = rng.uniform(0.1, 5.0, C)
    return (J.ClassState(counts=counts, sizes=sizes, weights=weights, sp=sp,
                         B=B),
            P.ClassState(counts=counts, sizes=sizes, weights=weights,
                         sp=port_speedup(sp), B=B))


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def _leaves_equal(spt, spj, rtol=0.0):
    for name in ("A", "w", "gamma"):
        np.testing.assert_allclose(np_(getattr(spt, name)),
                                   np.asarray(getattr(spj, name)),
                                   rtol=rtol, atol=0)
    np.testing.assert_array_equal(np.broadcast_to(np_(torch.as_tensor(
        spt.sigma)), np.shape(spj.sigma)), np.asarray(spj.sigma))


# ---------------------------------------------------------------------------
# The aggregation transform
# ---------------------------------------------------------------------------

FAMILY_MEMBERS = {
    "power": lambda: J.power(1.3, 0.6, B),
    "shifted": lambda: J.shifted_power(0.8, 2.5, 0.4, B),
    "log": lambda: J.log_speedup(1.1, 0.7, B),
    "neg_power": lambda: J.neg_power(0.9, 3.0, -1.2, B),
    "saturating": lambda: J.saturating(1.5, 22.0, 1.8, B),
}


@pytest.mark.parametrize("fam", list(FAMILY_MEMBERS))
def test_class_speedup_matches_jax(fam):
    """Shared scalar leaves and per-class leaves, counts 0, 1 and large:
    equal to JAX to 1e-15, the identity bit for bit at n = 1."""
    counts = np.array([0.0, 1.0, 7.0, 31250.0, 2.5])
    shared = FAMILY_MEMBERS[fam]()
    rng = np.random.default_rng(3)
    per = J.stack_speedups([shared] + [_rand_member(rng) for _ in range(4)])
    for spj in (shared, per):
        spt = port_speedup(spj)
        ref = J.class_speedup(spj, counts)
        out = P.class_speedup(spt, counts)
        assert type(out).__name__ == type(ref).__name__
        _leaves_equal(out, ref, rtol=1e-15)
        one = P.class_speedup(spt, np.ones(5))
        for name in ("A", "w", "gamma"):
            assert torch.equal(getattr(one, name),
                               torch.broadcast_to(getattr(spt, name),
                                                  (5,))), (fam, name)
        # an empty class keeps its own (n = 1) parameters
        assert torch.equal(out.A[0], one.A[0])


def test_class_speedup_rejects_generic():
    gen = P.GenericSpeedup(s_fn=torch.log1p, ds_fn=lambda t: 1.0 / (1.0 + t),
                           B=B)
    with pytest.raises(TypeError, match="regular-family"):
        P.class_speedup(gen, np.array([2.0]))


def test_aggregate_and_expand_match_jax():
    rng = np.random.default_rng(8)
    sj, st = _rand_state(rng, C=5, count_range=(0, 4))
    spj, Xj, Wj = J.aggregate_classes(sj)
    spt, X, W = P.aggregate_classes(st)
    _leaves_equal(spt, spj, rtol=1e-15)
    assert np.array_equal(np_(X), np.asarray(Xj))
    assert np.array_equal(np_(W), np.asarray(Wj))
    xj, wj, spjj, idj = J.expand_classes(sj)
    x, w, spjt, ids = P.expand_classes(st)
    for a, b in ((x, xj), (w, wj), (ids, idj)):
        assert np.array_equal(a, b)
    _leaves_equal(spjt, spjj)
    frac = P.ClassState(counts=np.array([1.5]), sizes=np.ones(1),
                        weights=np.ones(1), sp=port_speedup(J.power(1.0, 0.5,
                                                                     B)), B=B)
    with pytest.raises(ValueError, match="integral"):
        P.expand_classes(frac)


def test_class_state_validation():
    sp = port_speedup(J.power(1.0, 0.5, B))
    cases = [
        (dict(counts=np.ones(2), sizes=np.ones(3), weights=np.ones(2)),
         "must all be"),
        (dict(counts=np.ones((2, 2)), sizes=np.ones((2, 2)),
              weights=np.ones((2, 2))), "single-instance"),
        (dict(counts=np.array([1.0, -1.0]), sizes=np.ones(2),
              weights=np.ones(2)), "≥ 0"),
        (dict(counts=np.array([1.0, 2.0]), sizes=np.array([1.0, 0.0]),
              weights=np.ones(2)), "positive sizes"),
    ]
    for kw, msg in cases:
        with pytest.raises(ValueError, match=msg):
            J.ClassState(sp=J.power(1.0, 0.5, B), B=B, **kw)
        with pytest.raises(ValueError, match=msg):
            P.ClassState(sp=sp, B=B, **kw)
    st = P.ClassState(counts=[2, 0], sizes=[1.0, 0.0], weights=[1, 1],
                      sp=sp, B=B)
    assert st.C == 2 and st.jobs == 2.0 and st.counts.dtype == np.float64


# ---------------------------------------------------------------------------
# The planner: port vs JAX, port vs its oracle, oracle vs oracle
# ---------------------------------------------------------------------------

def _hold_plans(out, ref, what):
    """The same order; J and J_linear to 1e-9 where realized, J to 1e-6
    elsewhere; T to the reference's rtol 1e-6 / atol 1e-9."""
    assert np.array_equal(out.order, ref.order), what
    if _rel(ref.J, ref.J_linear) <= EXACT:
        assert _rel(out.J, ref.J) <= EXACT, (what, out.J, ref.J)
        assert _rel(out.J_linear, ref.J_linear) <= EXACT, what
    else:
        assert _rel(out.J, ref.J) <= ORACLE, (what, out.J, ref.J)
    np.testing.assert_allclose(out.T, ref.T, rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("seed", range(6))
def test_plan_classes_matches_jax_and_the_oracle(seed):
    """The reference's oracle anchor states (seeds 0–5).  The port's plan
    against JAX's, the port's plan against the port's oracle at its order
    (1e-8, T classwise), and the port's oracle equal to the reference's
    bit for bit at that order and at the oracle's own default order."""
    sj, st = _rand_state(np.random.default_rng(seed))
    ref = J.plan_classes(sj)
    out = P.plan_classes(st)
    _hold_plans(out, ref, seed)
    assert isinstance(out.sched, P.HeteroSmartFillSchedule)
    orc = P.plan_classes_reference(st, order=out.order)
    assert _rel(out.J, orc.J) < 1e-8, (seed, out.J, orc.J)
    np.testing.assert_allclose(out.T, orc.T, rtol=1e-6, atol=1e-9)
    for order in (out.order, None):
        a = P.plan_classes_reference(st, order=order)
        b = J.plan_classes_reference(sj, order=order)
        assert a.J == b.J and a.J_linear == b.J_linear
        for key in ("T", "theta", "theta_job", "order"):
            assert np.array_equal(getattr(a, key), getattr(b, key)), key


def test_plan_classes_million_scale_aggregates_match_jax():
    """Twelve classes of 31,250 jobs: the instance on which the per-job
    μ* search missed the reference's optimum by 5.9e-5 in J (ROADMAP
    Queue 3).  The same order, J and J_linear to 1e-9, and the port's
    numpy oracle at the plan's order to 1e-8.  From iteration 9 on μ*
    sits where F is flat, and T moves with it: the reference's compiled
    and op-by-op runs place T 2.7e-5 apart here
    (``tools/class_reference.py 2 12 31250``), so T is held to the JAX
    package's at 5e-5."""
    wj = J.sample_class_workloads(2, K=1, C=12, B=B,
                                  count_range=(31250, 31250))
    wp = P.sample_class_workloads(2, K=1, C=12, B=B,
                                  count_range=(31250, 31250), device="cpu")
    ref = J.plan_classes(wj.state(0))
    out = P.plan_classes(wp.state(0))
    assert np.array_equal(out.order, ref.order)
    assert _rel(ref.J, ref.J_linear) <= EXACT
    assert _rel(out.J, ref.J) <= EXACT and _rel(out.J, out.J_linear) <= EXACT
    assert _rel(out.J_linear, ref.J_linear) <= EXACT
    np.testing.assert_allclose(out.T, ref.T, rtol=5e-5)
    np.testing.assert_allclose(out.theta.sum(), B, rtol=1e-9)
    orc = P.plan_classes_reference(wp.state(0), order=out.order)
    assert _rel(out.J, orc.J) < 1e-8, (out.J, orc.J)


def test_one_job_per_class_is_the_per_job_plan_bit_for_bit():
    """At n_c = 1 the transform is the identity, so under the same knobs
    the class plan is the per-job plan: J, order, T and Θ equal."""
    for seed in range(3):
        _, st = _rand_state(np.random.default_rng(1000 + seed),
                            count_range=(1, 1))
        plan = P.plan_classes(st)
        per = P.smartfill_hetero(st.sp, st.sizes, st.weights, B=B,
                                 **CLASS_KNOBS)
        assert plan.J == per.J and plan.J_linear == per.J_linear, seed
        assert np.array_equal(plan.order, per.order)
        assert np.array_equal(plan.T[plan.order], np_(per.T))
        assert torch.equal(plan.sched.theta, per.theta)


def test_zero_count_classes_are_inert():
    rng = np.random.default_rng(17)
    C = 6
    spj = J.stack_speedups([_rand_member(rng) for _ in range(C)])
    sp = port_speedup(spj)
    sizes = rng.uniform(0.5, 20.0, C)
    weights = rng.uniform(0.1, 5.0, C)
    counts = np.array([3.0, 0.0, 7.0, 0.0, 0.0, 2.0])
    st = P.ClassState(counts=counts, sizes=sizes, weights=weights, sp=sp,
                      B=B)
    empty = np.flatnonzero(counts == 0)
    live = np.flatnonzero(counts > 0)
    for planner in (P.plan_classes, P.plan_classes_reference):
        plan = planner(st)
        assert np.all(plan.T[empty] == 0.0)
        assert np.all(plan.theta[empty] == 0.0)
        assert np.all(plan.theta_job[empty] == 0.0)
        assert sorted(plan.order) == list(live)
    idx = torch.as_tensor(live)
    stripped = P.ClassState(
        counts=counts[live], sizes=sizes[live], weights=weights[live],
        sp=P.StackedSpeedup(A=sp.A[idx], w=sp.w[idx], gamma=sp.gamma[idx],
                            sigma=sp.sigma[idx], B=B), B=B)
    full, compact = P.plan_classes(st), P.plan_classes(stripped)
    assert _rel(full.J, compact.J) < 1e-12
    np.testing.assert_allclose(full.T[live], compact.T, rtol=1e-12)
    ref = J.plan_classes(J.ClassState(counts=counts, sizes=sizes,
                                      weights=weights, sp=spj, B=B))
    _hold_plans(full, ref, "zero counts")


def test_all_empty_state_is_a_noop():
    sp = P.stack_speedups([P.power(1.0, 0.5, B, device="cpu"),
                           P.log_speedup(1.0, 1.0, B, device="cpu")])
    st = P.ClassState(counts=np.zeros(2), sizes=np.ones(2),
                      weights=np.ones(2), sp=sp, B=B)
    for planner in (P.plan_classes, P.plan_classes_reference):
        plan = planner(st)
        assert plan.J == 0.0 and plan.order.size == 0
        assert np.all(plan.T == 0.0) and np.all(plan.theta == 0.0)
        assert plan.sched is None


def test_plan_classes_needs_a_device_or_device_leaves():
    """Leaves on the CPU keep the plan there; with no GPU, asking for
    CUDA raises instead of carrying on elsewhere."""
    _, st = _rand_state(np.random.default_rng(0), C=2, count_range=(1, 3))
    assert P.plan_classes(st).sched.theta.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            P.plan_classes(st, device="cuda")


# ---------------------------------------------------------------------------
# The batched planner
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _batch():
    return (J.sample_class_workloads(21, K=12, C=6, B=B),
            P.sample_class_workloads(21, K=12, C=6, B=B, device="cpu"))


def test_compact_aggregate_batch_matches_jax():
    wj, wp = _batch()
    pj, spj, Xj, Wj = JC.compact_aggregate_batch(wj.counts, wj.sizes,
                                                 wj.weights, wj.sp)
    pp, spp, Xp, Wp = P.compact_aggregate_batch(wp.counts, wp.sizes,
                                                wp.weights, wp.sp)
    assert np.array_equal(pp, pj)
    assert np.array_equal(Xp, Xj) and np.array_equal(Wp, Wj)
    _leaves_equal(spp, spj, rtol=1e-15)
    # a shared per-class leaf becomes one copy per instance
    sp1 = map_leaves(wp.sp, lambda l: l[0])
    _, sp_shared, _, _ = P.compact_aggregate_batch(wp.counts, wp.sizes,
                                                   wp.weights, sp1)
    assert sp_shared.A.shape == (12, 6)
    with pytest.raises(ValueError, match=r"\(K, C\)"):
        P.compact_aggregate_batch(wp.counts[0], wp.sizes[0], wp.weights[0],
                                  sp1)


def test_batched_matches_jax_and_single_instance():
    wj, wp = _batch()
    orders_j, ref = J.plan_classes_batched(wj.counts, wj.sizes, wj.weights,
                                           wj.sp, B=B)
    orders, sched = P.plan_classes_batched(wp.counts, wp.sizes, wp.weights,
                                           wp.sp, B=B)
    assert np.array_equal(orders, np.asarray(orders_j))
    Jb, Jr = np_(sched.J), np.asarray(ref.J)
    Jl, Jlr = np_(sched.J_linear), np.asarray(ref.J_linear)
    realized = np.abs(Jr - Jlr) / Jr <= EXACT
    np.testing.assert_allclose(Jl, Jlr, rtol=EXACT)
    np.testing.assert_allclose(Jb[realized], Jr[realized], rtol=EXACT)
    np.testing.assert_allclose(Jb, Jr, rtol=ORACLE)
    th = np_(sched.theta)
    for k in range(12):
        # the batched planner keeps the heuristic order: the single
        # planner without its exchange search is the comparison
        single = P.plan_classes(wp.state(k), exchange_passes=0)
        assert _rel(float(Jb[k]), single.J) < 5e-6, k
        live = int((wp.counts[k] > 0).sum())
        assert np.all(wp.counts[k][orders[k][:live]] > 0)
        assert np.all(wp.counts[k][orders[k][live:]] == 0)
        assert np.all(th[k, live:, :] == 0.0)
        assert np.all(th[k, :, live:] == 0.0)
