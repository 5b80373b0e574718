"""Port vs JAX: the scenario engine against the JAX package's executors.

The same numpy workloads go through the port's batch-first engine
(``simulate_policy_device`` on the CPU, float64) and through the JAX
package's ``lax.scan`` engine and its numpy host oracle.  They must
agree with ``tests/core/test_simulator.py::_assert_match``'s semantics
at the reference's tolerance, RTOL = 1e-6: J, T, ``n_events``, and every
event's time and allocations.  The port's own host oracle is held to
the JAX oracle the same way.  Cheap policies run over all six speedup
families of the reference's ``SPS``; SmartFill on power, log and
saturating at M = 6; then the loop's edge cases.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.hesrpt as J_hesrpt
import repro.sched.policies as JP
import repro_torch.core as P
import repro_torch.core.hesrpt as P_hesrpt
import repro_torch.sched.policies as PP
from torch_port_util import assert_sim_match, port_speedup

B = 10.0
RTOL = 1e-6


def _generic_pair():
    spj = J.GenericSpeedup(
        s_fn=lambda t: jnp.log1p(t) + 0.5 * (jnp.sqrt(1.0 + t) - 1.0),
        ds_fn=lambda t: 1.0 / (1.0 + t) + 0.25 / jnp.sqrt(1.0 + t), B=B)
    spt = port_speedup(
        spj, s_fn=lambda t: torch.log1p(t) + 0.5 * (torch.sqrt(1.0 + t) - 1.0),
        ds_fn=lambda t: 1.0 / (1.0 + t) + 0.25 / torch.sqrt(1.0 + t))
    return spj, spt


def _pair(fam):
    if fam == "generic":
        return _generic_pair()
    spj = {"power": J.power(1.0, 0.5, B),
           "shifted": J.shifted_power(1.0, 4.0, 0.5, B),
           "log": J.log_speedup(1.0, 1.0, B),
           "neg_power": J.neg_power(5.0, 2.0, -1.0, B),
           "saturating": J.saturating(1.0, 12.0, 2.0, B)}[fam]
    return spj, port_speedup(spj)


FAMS = ["power", "shifted", "log", "neg_power", "saturating", "generic"]

POLICIES = {
    "hesrpt": (lambda sp: JP.HeSRPTPolicy(p=0.5, B=B),
               lambda sp: PP.HeSRPTPolicy(p=0.5, B=B)),
    "equi": (lambda sp: JP.EquiPolicy(B), lambda sp: PP.EquiPolicy(B)),
    "srpt1": (lambda sp: JP.SRPT1Policy(B), lambda sp: PP.SRPT1Policy(B)),
    "gwfstatic": (lambda sp: JP.GWFStaticPolicy(sp, B=B),
                  lambda sp: PP.GWFStaticPolicy(sp, B=B)),
}


def _instance(M=10):
    x = np.arange(M, 0, -1.0)
    return x, 1.0 / x


def _run_all(fam, mk_j, mk_p, x, w, arrival=None, jax_engine=True):
    """(port engine, port oracle, JAX oracle, JAX engine or None)."""
    spj, spt = _pair(fam)
    pj, pt = mk_j(spj), mk_p(spt)
    out = P.simulate_policy_device(spt, x, w, pt, B=B, arrival=arrival,
                                   device="cpu")
    ref_p = P.simulate_policy_reference(spt, x, w, pt.bind("cpu"), B=B,
                                        arrival=arrival)
    # the oracle calls the JAX policy once per event: compile it once
    jitted = jax.jit(lambda r, ww, a: pj(r, ww, a))
    ref = J.simulate_policy_reference(
        spj, x, w, lambda r, ww, a: np.asarray(jitted(r, ww, a)), B=B,
        arrival=arrival)
    dev = (J.simulate_policy_device(spj, x, w, pj, B=B, arrival=arrival)
           if jax_engine else None)
    return out, ref_p, ref, dev


@pytest.mark.parametrize("fam", FAMS)
@pytest.mark.parametrize("pol", list(POLICIES))
def test_engine_matches_jax_all_families(fam, pol):
    x, w = _instance(10)
    out, ref_p, ref, dev = _run_all(fam, *POLICIES[pol], x, w)
    assert_sim_match(out, ref, RTOL, B)
    assert_sim_match(out, dev, RTOL, B)
    assert_sim_match(ref_p, ref, RTOL, B)


@pytest.mark.parametrize("fam", ["power", "log", "saturating"])
def test_engine_matches_jax_smartfill(fam):
    """Re-planning SmartFill (a full solve per event): the closed-form
    μ*, parking and σ = −1."""
    x, w = _instance(6)
    out, ref_p, ref, dev = _run_all(
        fam, lambda sp: JP.SmartFillPolicy(sp, B=B),
        lambda sp: PP.SmartFillPolicy(sp, B=B), x, w)
    assert_sim_match(out, ref, RTOL, B)
    assert_sim_match(out, dev, RTOL, B)
    assert_sim_match(ref_p, ref, RTOL, B)


def test_coincident_completions():
    x = np.array([4.0, 2.0, 2.0, 2.0, 1.0])
    w = np.array([0.25, 0.5, 0.5, 0.5, 1.0])
    for name in ("equi", "hesrpt"):
        out, _, ref, _ = _run_all("power", *POLICIES[name], x, w,
                                  jax_engine=False)
        assert_sim_match(out, ref, RTOL, B)
    out, *_ = _run_all("power", *POLICIES["equi"], x, w, jax_engine=False)
    assert out.T[1] == out.T[2] == out.T[3]


def test_zero_weight_jobs():
    x = np.array([3.0, 2.0, 1.0])
    w = np.array([0.0, 0.0, 1.0])
    out, _, ref, _ = _run_all(
        "power", lambda sp: JP.SmartFillPolicy(sp, B=B),
        lambda sp: PP.SmartFillPolicy(sp, B=B), x, w, jax_engine=False)
    assert_sim_match(out, ref, RTOL, B)
    assert np.isfinite(out.J)


def test_zero_size_padding_stays_inert():
    x = np.array([5.0, 3.0, 0.0, 0.0])
    w = np.array([0.2, 1.0, 0.0, 0.0])
    out, _, ref, _ = _run_all("log", *POLICIES["hesrpt"], x, w,
                              jax_engine=False)
    assert_sim_match(out, ref, RTOL, B)
    assert out.T[2] == out.T[3] == 0.0
    for _, th in out.events:
        assert th[2] == th[3] == 0.0


@pytest.mark.parametrize("fam", ["power", "log"])
def test_arrivals_fold_in_as_events(fam):
    x, w = _instance(8)
    arr = np.array([0.0, 0.0, 0.0, 2.0, 2.0, 5.0, 0.0, 9.0])
    out, ref_p, ref, dev = _run_all(fam, *POLICIES["hesrpt"], x, w,
                                    arrival=arr)
    assert_sim_match(out, ref, RTOL, B)
    assert_sim_match(out, dev, RTOL, B)
    assert_sim_match(ref_p, ref, RTOL, B)
    ts = [t for t, _ in out.events]
    for t_arr in (2.0, 5.0):
        assert any(t == t_arr for t in ts)
    for t, th in out.events:
        assert np.all(th[arr > t] == 0.0)


def test_event_budget_is_4m_plus_16():
    assert P.n_events_for(8) == J.n_events_for(8) == 48
    x, w = _instance(8)
    arr = np.linspace(0.0, 3.0, 8)     # every job its own arrival event
    out, _, ref, _ = _run_all("power", *POLICIES["hesrpt"], x, w,
                              arrival=arr, jax_engine=False)
    assert_sim_match(out, ref, RTOL, B)
    assert out.n_events <= P.n_events_for(8)
    # a budget cut short leaves J = inf, as in the JAX engine
    spj, spt = _pair("power")
    cut = P.simulate_policy_device(spt, x, w, PP.HeSRPTPolicy(0.5, B),
                                   max_events=5, device="cpu")
    cut_j = J.simulate_policy_device(spj, x, w, JP.HeSRPTPolicy(0.5, B),
                                     max_events=5)
    assert cut.J == cut_j.J == np.inf and cut.n_events == cut_j.n_events == 5


@jax.tree_util.register_pytree_node_class
class _ZeroPolicyJ(JP.EquiPolicy):
    """Allocates nothing — every active job is parked forever."""

    def __call__(self, rem, w, active, B=None):
        return jnp.zeros_like(rem)


class _ZeroPolicy(PP.EquiPolicy):
    def _allocate(self, rem, w, active, b, moved):
        return torch.zeros_like(rem)


def test_unfinishable_instance_reports_inf():
    """All-parked deadlock halts instead of looping: J = +inf, as in the
    JAX engine; both host oracles raise."""
    x = np.array([2.0, 1.0])
    w = np.array([1.0, 1.0])
    spj, spt = _pair("power")
    out = P.simulate_policy_device(spt, x, w, _ZeroPolicy(B), device="cpu")
    ref = J.simulate_policy_device(spj, x, w, _ZeroPolicyJ(B))
    assert out.J == ref.J == np.inf and out.n_events == ref.n_events == 0
    host_zero = lambda r, w_, a: np.zeros_like(r)               # noqa: E731
    with pytest.raises(RuntimeError, match="deadlock"):
        P.simulate_policy_reference(spt, x, w, host_zero)
    with pytest.raises(RuntimeError, match="deadlock"):
        J.simulate_policy_reference(spj, x, w, host_zero)


def test_empty_instance():
    spj, spt = _pair("power")
    e = np.zeros(0)
    out = P.simulate_policy_device(spt, e, e, PP.EquiPolicy(B), B=B,
                                   device="cpu")
    ref = J.simulate_policy_reference(spj, e, e, JP.EquiPolicy(B), B=B)
    assert out.J == ref.J == 0.0
    assert out.n_events == ref.n_events == 0


def test_dispatch_host_callable_and_device_policy():
    """Host callables keep the reference loop, device-ready policies go
    to the engine; both agree with each other and with JAX."""
    spj, spt = _pair("power")
    x, w = _instance(9)
    via_host = P.simulate_policy(spt, x, w, P_hesrpt.hesrpt_policy(0.5, B),
                                 B=B)
    via_dev = P.simulate_policy(spt, x, w, PP.HeSRPTPolicy(p=0.5, B=B), B=B,
                                device="cpu")
    ref = J.simulate_policy(spj, x, w, J_hesrpt.hesrpt_policy(0.5, B), B=B)
    for out in (via_host, via_dev):
        assert abs(out.J - ref.J) / ref.J < RTOL
        np.testing.assert_allclose(out.T, ref.T, rtol=RTOL)
        assert out.n_events == ref.n_events
    with pytest.raises(ValueError, match="own budget"):
        P.simulate_policy(spt, x, w, PP.EquiPolicy(5.0), B=B, device="cpu")


def test_schedule_and_smartfill_sim_policies():
    """The host wrappers execute SmartFill's one-shot schedule and its
    re-planning through the host loop: J equals the planned J."""
    x = np.arange(6, 0, -1.0) * 2.0
    w = 1.0 / x
    spj, spt = _pair("log")
    plan = P.smartfill(spt, x, w, B=B)
    for pol in (P.schedule_policy(plan), P.smartfill_sim_policy(spt, B=B)):
        out = P.simulate_policy(spt, x, w, pol, B=B)
        assert abs(out.J - plan.J) / plan.J < RTOL
    ref = J.simulate_policy(spj, x, w, J.schedule_policy(J.smartfill(spj, x,
                                                                     w, B=B)),
                            B=B)
    out = P.simulate_policy(spt, x, w, P.schedule_policy(plan), B=B)
    assert_sim_match(out, ref, RTOL, B)


def test_float32_run_and_class_executor():
    """A float32 workload runs in float32 (completions register through
    the ulp-floored tolerance); the fluid class executor drains a small
    class state as the JAX package's does (the cached plan taken from
    JAX's policy, so the executors alone are compared)."""
    spj, spt = _pair("log")
    x, w = _instance(8)
    out = P.simulate_policy_device(
        spt, torch.tensor(x, dtype=torch.float32),
        torch.tensor(w, dtype=torch.float32), PP.GWFStaticPolicy(spt, B=B))
    ref = J.simulate_policy_reference(spj, x, w, JP.GWFStaticPolicy(spj, B=B),
                                      B=B)
    assert abs(out.J - ref.J) / ref.J < 1e-5
    assert out.events[0][1].dtype == np.float64
    sj, st = _class_pair(np.random.default_rng(2), C=3)
    pol_j, pol_p = _class_policies(sj, st)
    _assert_fluid_match(P.simulate_fluid_classes(st, pol_p),
                        J.simulate_fluid_classes(sj, pol_j))


@pytest.mark.parametrize("case", ["plain", "arrivals", "faults"])
def test_early_stop_gives_the_full_count_result(case, monkeypatch):
    """The loop stops once every workload has halted; running out the
    4M+16 (+2S) count instead, as the JAX engine does, gives the same
    J, T and n_events bit for bit: halted steps are no-ops."""
    import repro_torch.core.simulator as P_sim

    spt = P.shifted_power(1.0, 4.0, 0.5, B, device="cpu")
    wl = P.sample_workloads(3, K=6, M=5, B=B, m_range=(2, 5),
                            arrival_rate=0.7 if case == "arrivals" else 0.0)
    kw = {}
    if case == "arrivals":
        kw["arrival"] = wl.arrival
    if case == "faults":
        kw["faults"] = P.sample_fault_traces(4, 6, 5, B=B, horizon=4.0,
                                             preempt_rate=0.7, fail_rate=0.5,
                                             straggle_rate=0.5)
    pols = (PP.HeSRPTPolicy(0.5, B), PP.GWFStaticPolicy(spt, B=B))
    early = P.simulate_ensemble(spt, pols, wl.X, wl.W, **kw)
    monkeypatch.setattr(P_sim, "stops_early", lambda *a, **k: False)
    full = P.simulate_ensemble(spt, pols, wl.X, wl.W, **kw)
    for name in ("J", "T", "n_events", "finished", "exhausted"):
        assert torch.equal(getattr(early, name), getattr(full, name)), name


# ---------------------------------------------------------------------------
# The fluid class executor (core/classes.py states)
# ---------------------------------------------------------------------------

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


def _class_pair(rng, C, count_range=(0, 50), extra=0.0):
    """``tests/core/test_classes.py::_rand_state`` for both packages;
    ``extra`` is added to every count (fractional, fluid counts)."""
    sp = J.stack_speedups([_rand_member(rng) for _ in range(C)])
    lo, hi = count_range
    counts = rng.integers(lo, hi + 1, C).astype(np.float64)
    if not (counts > 0).any():
        counts[rng.integers(0, C)] = 1.0
    counts = counts + extra
    sizes = rng.uniform(0.5, 20.0, C)
    weights = rng.uniform(0.1, 5.0, C)
    return (J.ClassState(counts=counts, sizes=sizes, weights=weights, sp=sp,
                         B=B),
            P.ClassState(counts=counts, sizes=sizes, weights=weights,
                         sp=port_speedup(sp), B=B))


def _class_policies(sj, st):
    """JAX's pinned, cached class policy and the port's with JAX's rank
    and table: the plans of the two packages agree on Θ only to ~1e-7
    (μ* at a flat minimum), the executors must agree to 1e-9."""
    pol_j = JP.ClassSmartFillPolicy.from_classes(sj, pin=True,
                                                 cache_plan=True)
    pol_p = PP.ClassSmartFillPolicy(
        sp=P.class_speedup(st.sp, st.counts), B=B,
        rank=torch.tensor(np.array(pol_j.rank)),
        theta=torch.tensor(np.array(pol_j.theta)))
    return pol_j, pol_p


def _assert_fluid_match(out, ref, rtol=1e-9):
    assert out.finished and ref.finished
    np.testing.assert_allclose(out.T, ref.T, rtol=rtol, atol=0)
    for key in ("J_fluid", "J_jobs"):
        assert abs(getattr(out, key) - getattr(ref, key)) <= rtol * abs(
            getattr(ref, key)), key
    assert out.n_events == ref.n_events == len(out.events)
    for (to, tho), (tr, thr) in zip(out.events, ref.events):
        assert abs(to - tr) <= rtol * max(1.0, tr)
        np.testing.assert_allclose(tho, np.asarray(thr), atol=1e-12 * B)


@pytest.mark.parametrize("seed,extra", [(0, 0.0), (5, 0.0), (9, 0.5)])
def test_fluid_classes_match_jax(seed, extra):
    """T, J_fluid and J_jobs to 1e-9, the same n_events and event times,
    integral and fractional counts."""
    sj, st = _class_pair(np.random.default_rng(seed), C=5, extra=extra)
    pol_j, pol_p = _class_policies(sj, st)
    _assert_fluid_match(P.simulate_fluid_classes(st, pol_p),
                        J.simulate_fluid_classes(sj, pol_j))


def test_fluid_pinned_drain_reproduces_the_plan():
    """The port's pinned, cached policy executes the port's plan: T and
    J to 1e-9, J_fluid ≤ J_jobs, within the 2C + 8 event budget."""
    for seed in (0, 5, 9):
        _, st = _class_pair(np.random.default_rng(seed), C=5)
        plan = P.plan_classes(st)
        pol = PP.ClassSmartFillPolicy.from_classes(st, pin=True,
                                                   cache_plan=True)
        res = P.simulate_fluid_classes(st, pol)
        assert res.finished and res.n_events <= 2 * st.C + 8
        live = st.counts > 0
        np.testing.assert_allclose(res.T[live], plan.T[live], rtol=1e-9)
        assert np.all(res.T[~live] == 0.0)
        assert abs(res.J_jobs - plan.J) <= 1e-9 * plan.J
        assert res.J_fluid <= res.J_jobs * (1 + 1e-12)


def test_fluid_rerank_ablation_never_better():
    """pin=False re-ranks the classes at every event: never better than
    the pinned plan, and strictly worse somewhere."""
    strictly_worse = 0
    for seed in (1, 4, 7, 12):
        _, st = _class_pair(np.random.default_rng(seed), C=5)
        pinned = P.simulate_fluid_classes(
            st, PP.ClassSmartFillPolicy.from_classes(st, pin=True,
                                                     cache_plan=True))
        rerank = P.simulate_fluid_classes(
            st, PP.ClassSmartFillPolicy.from_classes(st, pin=False))
        assert pinned.finished and rerank.finished
        assert rerank.J_jobs >= pinned.J_jobs * (1 - 1e-9)
        if rerank.J_jobs > pinned.J_jobs * (1 + 1e-6):
            strictly_worse += 1
    assert strictly_worse >= 1


def test_fluid_cdr_ratio_constant_along_the_trajectory():
    """Cor. 2.1 over aggregates: S_i'(Θ_i)/S_j'(Θ_j) is one constant over
    the events where both classes run (spread below 1e-6)."""
    checked = 0
    for seed in (1, 3, 5, 8):
        _, st = _class_pair(np.random.default_rng(seed), C=5,
                            count_range=(1, 30))
        res = P.simulate_fluid_classes(
            st, PP.ClassSmartFillPolicy.from_classes(st, pin=True,
                                                     cache_plan=True))
        assert res.finished
        sp_agg = P.class_speedup(st.sp, st.counts)
        ratios = {}
        for _, th in res.events:
            pos = np.flatnonzero(th > 1e-7 * B)
            ds = sp_agg.ds(torch.as_tensor(th)).numpy()
            for a in pos:
                for b in pos[pos > a]:
                    ratios.setdefault((a, b), []).append(ds[a] / ds[b])
        spreads = [(max(r) - min(r)) / max(r) for r in ratios.values()
                   if len(r) >= 2]
        if spreads:
            checked += 1
            assert max(spreads) < 1e-6, (seed, spreads)
    assert checked >= 2


def test_fluid_event_budget_early_stop_and_empty_states(monkeypatch):
    """Stopping once a step neither advanced time nor completed a class
    gives what running out the 2C + 8 count gives; a cut budget leaves
    the run unfinished with J = inf; empty classes stay inert; a C = 0
    state is a no-op."""
    import repro_torch.core.simulator as P_sim

    _, st = _class_pair(np.random.default_rng(4), C=5, count_range=(0, 3))
    pol = PP.ClassSmartFillPolicy.from_classes(st, pin=True, cache_plan=True)
    early = P.simulate_fluid_classes(st, pol)
    cut = P.simulate_fluid_classes(st, pol, max_events=1)
    assert not cut.finished and cut.J_jobs == cut.J_fluid == float("inf")
    monkeypatch.setattr(P_sim, "stops_early", lambda *a, **k: False)
    full = P.simulate_fluid_classes(st, pol)
    assert np.array_equal(early.T, full.T)
    assert (early.J_fluid, early.J_jobs, early.n_events, early.finished) == (
        full.J_fluid, full.J_jobs, full.n_events, full.finished)
    assert all(np.array_equal(a[1], b[1]) and a[0] == b[0]
               for a, b in zip(early.events, full.events))
    assert np.all(early.T[st.counts == 0] == 0.0)
    none = P.ClassState(counts=np.zeros(0), sizes=np.zeros(0),
                        weights=np.zeros(0), sp=st.sp, B=B)
    res = P.simulate_fluid_classes(none, pol)
    assert res.finished and res.n_events == 0 and res.J_jobs == 0.0
