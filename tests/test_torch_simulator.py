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
    the ulp-floored tolerance); the fluid class executor waits for
    slice C."""
    spj, spt = _pair("log")
    x, w = _instance(8)
    out = P.simulate_policy_device(
        spt, torch.tensor(x, dtype=torch.float32),
        torch.tensor(w, dtype=torch.float32), PP.GWFStaticPolicy(spt, B=B))
    ref = J.simulate_policy_reference(spj, x, w, JP.GWFStaticPolicy(spj, B=B),
                                      B=B)
    assert abs(out.J - ref.J) / ref.J < 1e-5
    assert out.events[0][1].dtype == np.float64
    with pytest.raises(NotImplementedError, match="slice C"):
        P.simulate_fluid_classes(None, None)


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
