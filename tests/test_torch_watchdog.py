"""Port vs JAX: the host watchdog (``robust/watchdog.py``) and the
admission controller's degraded deny-all decision.

The watchdog is host-only code: both packages run the same retries,
backoff and seeded jitter in virtual time, so a replay gives the same
sleep sequence and counters in both.
"""
import numpy as np
import pytest

import repro.core as J
import repro.robust as JR
import repro.serve.admission as jadm
import repro_torch.robust as PR
import repro_torch.serve.admission as adm
from torch_port_util import port_speedup


class VirtualClock:
    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s

    def clock(self):
        return self.t


def _wd(R=PR, **kw):
    vc = VirtualClock()
    kw.setdefault("backoff_s", 1.0)
    kw.setdefault("jitter", 0.0)
    return R.Watchdog(sleep=vc.sleep, clock=vc.clock, **kw), vc


def test_retries_then_succeeds():
    wd, vc = _wd(retries=3)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise RuntimeError("transient")
        return 42

    assert wd.call(flaky) == 42
    assert wd.stats == {"attempts": 3, "failures": 2, "timeouts": 0,
                        "rejections": 0, "giveups": 0}
    assert vc.sleeps == [1.0, 2.0]      # exponential backoff, no jitter


def test_gives_up_with_cause():
    wd, _ = _wd(retries=1, backoff_s=0.0)

    def broken():
        raise KeyError("dead")

    with pytest.raises(PR.WatchdogGiveUp) as ei:
        wd.call(broken, label="scorer")
    assert "scorer" in str(ei.value)
    assert isinstance(ei.value.__cause__, KeyError)
    assert wd.giveups == 1 and wd.attempts == 2


def test_validation_rejects_bad_results():
    wd, _ = _wd(retries=2, backoff_s=0.0)
    results = iter([np.array([np.nan]), np.array([np.inf]),
                    np.array([1.0])])
    out = wd.call(lambda: next(results),
                  validate=lambda a: bool(np.all(np.isfinite(a))))
    assert out == np.array([1.0])
    assert wd.rejections == 2


def test_posthoc_timeout_counts_as_failure():
    wd, vc = _wd(retries=1, timeout_s=0.5, backoff_s=0.0)
    slow_then_fast = iter([2.0, 0.1])

    def fn():
        vc.t += next(slow_then_fast)    # the call itself burns time
        return "ok"

    assert wd.call(fn) == "ok"
    assert wd.timeouts == 1 and wd.attempts == 2


def test_jitter_is_seeded_as_the_reference_seeds_it():
    """The same seed gives the same jittered sleeps — in both packages,
    so a replay of a reference run sleeps as it did."""
    runs = [_wd(R, retries=3, jitter=0.3, seed=5) for R in (PR, PR, JR)]
    for wd, _ in runs:
        with pytest.raises(Exception):
            wd.call(lambda: (_ for _ in ()).throw(RuntimeError()))
    a, b, ref = (vc.sleeps for _, vc in runs)
    assert a == b == ref
    assert a != [1.0, 2.0, 4.0]         # jitter actually moved them


def test_wrap_is_drop_in():
    wd, _ = _wd(retries=1, backoff_s=0.0)
    safe = wd.wrap(lambda x: x * 2)
    assert safe(21) == 42


def test_reset_stats():
    wd, _ = _wd(retries=0)
    wd.call(lambda: 1)
    wd.reset_stats()
    assert wd.stats["attempts"] == 0


# ---------------------------------------------------------------------------
# Admission integration: degraded deny-all instead of a crash
# ---------------------------------------------------------------------------
def test_admission_degrades_to_deny_all(monkeypatch):
    spj = J.power(1.0, 0.5, 8.0)
    sp = port_speedup(spj)
    rs = np.array([5.0, 3.0]); rw = 1.0 / rs
    cs = np.array([2.0, 1.0]); cw = 1.0 / cs

    wd, _ = _wd(retries=1, backoff_s=0.0)
    ctrl = adm.AdmissionController(sp, B=8.0, watchdog=wd)
    healthy = ctrl.evaluate(rs, rw, cs, cw)
    assert healthy.ok and healthy.status == "ok"
    plain = adm.AdmissionController(sp, B=8.0).evaluate(rs, rw, cs, cw)
    np.testing.assert_array_equal(healthy.marginal_cost, plain.marginal_cost)
    ref = jadm.AdmissionController(spj, B=8.0).evaluate(rs, rw, cs, cw)
    np.testing.assert_allclose(healthy.marginal_cost, ref.marginal_cost,
                               rtol=1e-9)

    def wedged(*a, **k):
        raise RuntimeError("device wedged")

    monkeypatch.setattr(adm, "smartfill_batched", wedged)
    dec = ctrl.evaluate(rs, rw, cs, cw)
    assert not dec.ok and dec.status.startswith("degraded:")
    assert not dec.admit.any()
    assert np.all(np.isinf(dec.marginal_cost))
    assert np.isnan(dec.baseline_J)
    assert wd.giveups == 1


def test_admission_watchdog_rejects_nonfinite_scores(monkeypatch):
    """A scorer that *returns* NaN (instead of raising) is caught by the
    watchdog's validation and still degrades safely."""
    sp = port_speedup(J.power(1.0, 0.5, 8.0))
    rs = np.array([4.0]); rw = 1.0 / rs
    cs = np.array([2.0]); cw = 1.0 / cs

    class FakeSched:
        J = np.array([np.nan, np.nan])

    wd, _ = _wd(retries=1, backoff_s=0.0)
    ctrl = adm.AdmissionController(sp, B=8.0, watchdog=wd)
    monkeypatch.setattr(adm, "smartfill_batched",
                        lambda *a, **k: FakeSched())
    dec = ctrl.evaluate(rs, rw, cs, cw)
    assert not dec.ok and wd.rejections == 2
    assert dec.status.startswith("degraded:")
