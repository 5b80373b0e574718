"""Port vs JAX: the streaming half of ``sched/policies.py``.

``StreamPlan``, the host-side ``StreamingSmartFillPolicy`` (carried
order, release on slot recycling, warm against cold, per-job §7
replanning), and the per-event cascade ``stream_replan_core`` with its
host mirror ``StreamCascadePolicy``.  Every case feeds the same numpy
live states to both packages in float64: the same orders and flags,
J and tables to 1e-12 (the cascade) or 1e-10 (warm against cold, the
reference's own parity bound).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.sched.policies as JP
import repro_torch.core as P
from repro.robust import DegradingPolicy as JDegrading
from repro_torch.robust import DegradingPolicy
from repro_torch.sched.policies import (HostReads, StreamCascadePolicy,
                                        StreamingSmartFillPolicy,
                                        StreamPlan, stream_replan_core,
                                        stream_warm0)
from torch_port_util import np_

B = 10.0
M = 8
CPU = torch.device("cpu")


def SP():
    return P.power(1.0, 0.5, B, device="cpu")


def JSP():
    return J.power(1.0, 0.5, B)


class ColdOnly(StreamingSmartFillPolicy):
    """The from-scratch path on every replan (the parity baseline)."""

    def plan(self, rem, w, active=None, B=None, warm=True):
        return super().plan(rem, w, active=active, B=B, warm=False)


def test_stream_plan_slot_allocations():
    table = np.triu(np.arange(1.0, 17.0).reshape(4, 4))
    kw = dict(order=np.array([2, 0, 3]), J=0.0, J_linear=0.0, m=3, B=B,
              warm=False, certified=True)
    got = StreamPlan(table=torch.tensor(table), **kw).slot_allocations()
    ref = JP.StreamPlan(table=jnp.asarray(table), **kw).slot_allocations()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, [table[1, 2], 0.0, table[0, 2],
                                        table[2, 2]])
    empty = StreamPlan(table=torch.zeros((4, 4)), **{**kw, "m": 0})
    np.testing.assert_array_equal(empty.slot_allocations(), np.zeros(4))


def test_warm_equals_cold_per_state_and_matches_jax():
    # the reference's state-by-state parity (tests/serve/test_stream.py):
    # live state evolves by executing the warm plan between replans; at
    # step 10 the budget collapses and the warm λ-bracket goes stale.
    # Each warm plan equals a cold one (1e-10) and JAX's warm plan on
    # the same state (same order and warm flag, J 1e-10).
    rng = np.random.default_rng(0)
    warm = StreamingSmartFillPolicy(SP(), B)
    jwarm = JP.StreamingSmartFillPolicy(JSP(), B)
    rem = np.zeros(M)
    act = np.zeros(M, bool)
    w = np.ones(M)
    live_B = B
    for step in range(25):
        if step == 10:
            live_B = 0.2 * B
        free = np.flatnonzero(~act)
        if free.size and rng.random() < 0.8:
            s = free[0]
            act[s] = True
            rem[s] = rng.uniform(0.5, 20.0)
            w[s] = 1.0 / rem[s]
        if not act.any():
            continue
        pw = warm.plan(rem, w, act, B=live_B)
        pc = ColdOnly(SP(), B).plan(rem, w, act, B=live_B)
        pj = jwarm.plan(rem, w, act, B=live_B)
        assert pw.certified and pc.certified, step
        assert abs(pw.J - pc.J) <= 1e-10 * max(1.0, abs(pc.J)), step
        np.testing.assert_array_equal(pw.order, pj.order)
        assert pw.warm == pj.warm, step
        assert abs(pw.J - pj.J) <= 1e-10 * max(1.0, abs(pj.J)), step
        theta = pw.slot_allocations()
        np.testing.assert_allclose(theta, pj.slot_allocations(), rtol=1e-9,
                                   atol=1e-12)
        rate = np.where(act, np_(SP().s(torch.tensor(theta))), 0.0)
        dt = rng.uniform(0.2, 1.5) * float(
            np.min(rem[act] / np.maximum(rate[act], 1e-300)))
        rem = np.maximum(rem - rate * dt, 0.0)
        done = act & (rem <= 1e-12)
        act &= ~done
        if done.any():
            warm.release(np.flatnonzero(done))
            jwarm.release(np.flatnonzero(done))
    assert warm.warm_replans == jwarm.warm_replans > 5
    assert warm.cold_replans == jwarm.cold_replans


def test_release_prevents_slot_recycling_corruption():
    # a completed job's slot goes to a *larger* job: without release()
    # it would inherit the old job's position in the carried order
    pol = StreamingSmartFillPolicy(SP(), B)
    rem = np.array([16.0, 5.0, 4.0])
    w = 1.0 / rem
    act = np.ones(3, bool)
    pol.plan(rem, w, act)
    pol.release([2])
    rem2 = np.array([15.0, 3.5, 6.3])
    w2 = np.array([w[0], w[1], 1.0 / 6.3])
    pw = pol.plan(rem2, w2, act)
    pc = ColdOnly(SP(), B).plan(rem2, w2, act)
    assert pw.warm and pw.certified and pc.certified
    np.testing.assert_array_equal(pw.order, pc.order)
    assert abs(pw.J - pc.J) <= 1e-10 * max(1.0, abs(pc.J))
    jpol = JP.StreamingSmartFillPolicy(JSP(), B)
    jpol.plan(rem, w, act)
    jpol.release([2])
    np.testing.assert_array_equal(pw.order, jpol.plan(rem2, w2, act).order)


def test_release_with_absent_slots_is_harmless():
    pol = StreamingSmartFillPolicy(SP(), B)
    pol.release([0, 1])                          # before any plan
    assert pol._order.size == 0
    rem = np.array([9.0, 4.0, 2.0])
    w = 1.0 / rem
    act = np.ones(3, bool)
    pol.plan(rem, w, act)
    carried = pol._order.copy()
    pol.release([7, 12])
    np.testing.assert_array_equal(pol._order, carried)
    pol.release([1])
    pol.release([1, 5])
    np.testing.assert_array_equal(pol._order, carried[carried != 1])
    p2 = pol.plan(np.array([8.0, 3.0, 1.5]), w, act)
    assert p2.warm and p2.certified


def test_per_job_warm_parity_against_jax():
    # per-job speedups: the cold plan runs the §7 exchange search, the
    # warm replan after a shrink keeps the carried order; both equal
    # JAX's smartfill_hetero on the same instance (1e-9)
    def stacked(pkg, **kw):
        return pkg.stack_speedups([pkg.power(1.0, 0.4, B, **kw),
                                   pkg.saturating(0.5, 12.0, 2.0, B, **kw),
                                   pkg.power(1.0, 0.7, B, **kw)])

    sp_pj, jsp_pj = stacked(P, device="cpu"), stacked(J)
    x = np.array([6.0, 4.0, 2.0])
    w = np.array([1.0, 0.5, 2.0])
    pol = StreamingSmartFillPolicy(sp_pj, B)
    p_cold = pol.plan(x, w)
    assert not p_cold.warm and p_cold.certified and pol.order_searches == 1
    ref = J.smartfill_hetero(jsp_pj, x, w, B=B)
    np.testing.assert_array_equal(p_cold.order, np.asarray(ref.order))
    assert abs(p_cold.J - ref.J) <= 1e-9 * max(1.0, ref.J)
    x2 = x * 0.8
    p_warm = pol.plan(x2, w)
    assert p_warm.warm and p_warm.certified
    ref2 = J.smartfill_hetero(jsp_pj, x2, w, B=B)
    assert abs(p_warm.J - ref2.J) <= 1e-9 * max(1.0, ref2.J)


# ---------------------------------------------------------------------------
# The cascade: stream_replan_core and StreamCascadePolicy against JAX's
# ---------------------------------------------------------------------------

def _live_state(seed, weights):
    """A half-served live state: sizes shrunk from their arrival size,
    weights from the arrival size ('slowdown': 1/x₀, non-agreeable once
    the sizes shrink) or random; one or two slots free."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(0.5, 20.0, M)
    rem = x0 * rng.uniform(0.05, 1.0, M)
    w = 1.0 / x0 if weights == "slowdown" else rng.uniform(0.1, 5.0, M)
    act = np.ones(M, bool)
    act[rng.choice(M, int(rng.integers(1, 3)), replace=False)] = False
    rem = np.where(act, rem, 0.0)
    return rem, w, act


def _core_pair(rem, w, act, B_live, search_steps=4 * M):
    sp = SP()
    lad = DegradingPolicy.ladder(sp, B=B)
    warm0 = stream_warm0(M, torch.float64, CPU)
    got = stream_replan_core(
        sp, lad, torch.tensor(rem), torch.tensor(w), torch.tensor(act),
        B_live, B, warm0, 1e-8, fast=True, search_steps=search_steps)
    jsp = JSP()
    ref = JP._cascade_call(
        jsp, JDegrading.ladder(jsp, B=B), jnp.asarray(rem), jnp.asarray(w),
        jnp.asarray(act), B_live, B, JP.stream_warm0(M), 1e-8, fast=True,
        coarse=32, descent_iters=40, cap_iters=64, stol_rel=None,
        search_steps=search_steps)
    return got, ref


def _assert_core_equal(got, ref):
    order, table, m, cert, searched, Jv, J_lin, warm2 = got
    np.testing.assert_array_equal(np_(order), np.asarray(ref[0]))
    assert int(m) == int(ref[2])
    assert cert == bool(ref[3]) and searched == bool(ref[4])
    np.testing.assert_allclose(np_(table), np.asarray(ref[1]), rtol=1e-12,
                               atol=1e-12)
    if cert:
        assert abs(float(Jv) - float(ref[5])) <= 1e-12 * abs(float(ref[5]))
    np.testing.assert_allclose(np_(warm2.bracket),
                               np.asarray(ref[7].bracket), rtol=1e-12)


@pytest.mark.parametrize("seed,weights,B_live", [
    (0, "slowdown", B), (1, "slowdown", 0.3 * B), (2, "random", B),
    (3, "random", 0.6 * B), (4, "random", B)])
def test_stream_replan_core_matches_jax(seed, weights, B_live):
    rem, w, act = _live_state(seed, weights)
    got, ref = _core_pair(rem, w, act, B_live)
    _assert_core_equal(got, ref)


def test_search_branch_fires_on_random_weights():
    # random weights break the agreeable structure: the fresh ranking
    # fails the certificate and the exchange search must rescue it, in
    # both packages the same way
    fired = 0
    for seed in range(5, 13):
        rem, w, act = _live_state(seed, "random")
        got, ref = _core_pair(rem, w, act, B)
        _assert_core_equal(got, ref)
        fired += got[4] and got[3]
    assert fired >= 2


def test_ladder_branch_when_the_search_cannot_run():
    # no search step allowed: an uncertified fresh ranking goes straight
    # to the ladder's table on the SJF ranking, every column gated
    for seed in range(5, 13):
        rem, w, act = _live_state(seed, "random")
        got, ref = _core_pair(rem, w, act, B, search_steps=0)
        _assert_core_equal(got, ref)
        if not got[3]:
            table = np_(got[1])
            assert np.all(table >= 0.0)
            assert np.all(table.sum(0) <= B * (1 + 1e-9))
            return
    pytest.fail("no state left the fresh ranking uncertified")


def test_host_reads_of_the_cascade():
    rem, w, act = _live_state(0, "slowdown")
    read = HostReads()
    out = stream_replan_core(
        SP(), DegradingPolicy.ladder(SP(), B=B), torch.tensor(rem),
        torch.tensor(w), torch.tensor(act), B, B,
        stream_warm0(M, torch.float64, CPU), 1e-8, fast=True, read=read)
    assert out[3] and not out[4] and read.n == 1


def test_cascade_policy_matches_jax_over_a_sequence():
    # the warm payload is carried from one replan to the next, through a
    # budget dip; every plan and every counter equals JAX's mirror
    pol = StreamCascadePolicy(SP(), B)
    jpol = JP.StreamCascadePolicy(JSP(), B)
    for k, B_live in enumerate([B, B, 0.25 * B, B, B, 0.6 * B]):
        rem, w, act = _live_state(20 + k, "random" if k % 2 else "slowdown")
        p, pj = pol.plan(rem, w, act, B=B_live), jpol.plan(rem, w, act,
                                                           B=B_live)
        np.testing.assert_array_equal(p.order, pj.order)
        assert (p.m, p.warm, p.certified) == (pj.m, pj.warm, pj.certified)
        np.testing.assert_allclose(np_(p.table), np.asarray(pj.table),
                                   rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(p.slot_allocations(),
                                   pj.slot_allocations(), rtol=1e-12,
                                   atol=1e-12)
    assert (pol.warm_replans, pol.cold_replans, pol.order_searches) == (
        jpol.warm_replans, jpol.cold_replans, jpol.order_searches)


def test_cascade_policy_rejects_per_job_speedups():
    sp_pj = P.stack_speedups([P.power(1.0, 0.4, B, device="cpu"),
                              P.power(1.0, 0.6, B, device="cpu")])
    with pytest.raises(ValueError, match="shared"):
        StreamCascadePolicy(sp_pj, B)


@pytest.mark.parametrize("family", ["power", "log"])
def test_search_rows_have_the_bits_of_a_solo_solve(family):
    # the exchange search scores its M−1 candidate orders in one batched
    # solve; each row must give the bits of that order solved alone (the
    # pow, the reductions over M), or a near tie could pick another swap
    # than the one-order-at-a-time reference
    from repro_torch.core.smartfill import _solve
    sp = (P.power(1.0, 0.5, B, device="cpu") if family == "power"
          else P.log_speedup(1.0, 1.0, B, device="cpu"))
    rem, w, act = _live_state(30, "random")
    rem, w = torch.tensor(rem), torch.tensor(w)
    m = torch.tensor(int(act.sum()))
    base = torch.argsort(torch.where(torch.tensor(act), -rem, torch.inf),
                         stable=True)
    ci = torch.arange(M - 1)
    orders = base.expand(M - 1, M).clone()
    orders[ci, ci] = base[ci + 1]
    orders[ci, ci + 1] = base[ci]
    warm = stream_warm0(M, torch.float64, CPU)
    idx = torch.arange(M)

    def solve(o):
        n = o.shape[0]
        return _solve(sp, torch.where(idx < m, rem[o], 0.0),
                      torch.where(idx < m, w[o], 0.0),
                      torch.full((n,), B, dtype=torch.float64),
                      m.expand(n).contiguous(), 32, 40, 64,
                      family == "power", lam0=warm.lam.expand(n, M),
                      bracket0=warm.bracket.expand(n, 2))

    batch = solve(orders)
    for i in range(M - 1):
        one = solve(orders[i:i + 1])
        for b, o in zip(batch, one):
            assert torch.equal(b[i], o[0]), i
