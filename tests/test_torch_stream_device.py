"""The device event loop: ``StreamController.run_device``.

Its contract is *bit parity* with the host loop running the same
``StreamCascadePolicy`` — the host loop is kept to be its differential
oracle.  Every stage of the replan cascade (fresh hinted solve →
certificate → exchange search → ladder) and every window mechanic
(double-buffer promotion mid-window, cut-at-first-completion backfill,
FIFO queueing, budget events) must make the same decision and produce
the same floats over the carry of device tensors as through the host
loop: completions, every counter and the metrics, with ``torch.equal``
rigour.  The port's device loop is also held to the JAX package's
``run_device`` on the same numpy traces: the same counts and finished
sets, completions and weighted J to 1e-9 relative.
"""
import numpy as np
import pytest

import repro.core as J
import repro.serve as JS
import repro_torch.core as P
from repro_torch.serve import (AdmissionController, StreamCascadePolicy,
                               StreamController)
from repro_torch.serve.stream import _event_arrays

B = 10.0


def SP():
    return P.power(1.0, 0.5, B, device="cpu")


def stream_of(seed, horizon, *, rate, weights="slowdown", n_budget_events=2,
              **kw):
    return P.sample_arrival_stream(
        seed, horizon=horizon, rate=rate, diurnal=0.75, period=horizon,
        weights=weights, B=B, n_budget_events=n_budget_events,
        budget_frac=(0.3, 0.8), **kw)


def cascade(M, latency=0.0):
    return StreamController(SP(), B, max_live=M,
                            policy=StreamCascadePolicy(SP(), B),
                            plan_latency=latency)


def assert_bit_parity(host, dev):
    np.testing.assert_array_equal(host.completion, dev.completion)
    for f in ("replans", "warm_replans", "cold_replans",
              "degraded_windows", "n_events"):
        assert getattr(host, f) == getattr(dev, f), f
    assert host.metrics == dev.metrics


def assert_matches_jax(got, ref, rtol=1e-9):
    fin = np.isfinite(ref.completion)
    np.testing.assert_array_equal(np.isfinite(got.completion), fin)
    np.testing.assert_allclose(got.completion[fin], ref.completion[fin],
                               rtol=rtol)
    for f in ("replans", "warm_replans", "cold_replans",
              "degraded_windows", "n_events"):
        assert getattr(got, f) == getattr(ref, f), f
    assert got.metrics.n_completed == ref.metrics.n_completed
    np.testing.assert_allclose(got.metrics.weighted_J,
                               ref.metrics.weighted_J, rtol=rtol)


def jax_run_device(stream, M, latency=0.0):
    jsp = J.power(1.0, 0.5, B)
    return JS.StreamController(
        jsp, B, max_live=M, policy=JS.StreamCascadePolicy(jsp, B),
        plan_latency=latency).run_device(stream)


@pytest.mark.parametrize("seed,M,latency,weights,rate", [
    (3, 6, 0.0, "slowdown", 0.15),     # warm cascade only
    (11, 5, 2.0, "slowdown", 0.12),    # double-buffered mid-window splits
    (5, 6, 0.0, "random", 0.25),       # non-agreeable: search and ladder
])
def test_device_matches_host_oracle_and_jax(seed, M, latency, weights, rate):
    stream = stream_of(seed, 1200.0, rate=rate, weights=weights)
    ctl = cascade(M, latency)
    host = ctl.run(stream)
    dev = ctl.run_device(stream)
    assert_bit_parity(host, dev)
    # a few host reads an event: the window loop, the cut, the queue's
    # landings and the cascade's branches
    assert 0 < ctl.host_reads <= 16 * _event_arrays(stream)[0].size
    assert_matches_jax(dev, jax_run_device(stream, M, latency))


def test_device_chunked_equals_single_dispatch():
    # chunk_events splits the trace into several chunks with the carry
    # handed across — the seam must be invisible
    stream = stream_of(7, 1500.0, rate=0.2)
    ctl = cascade(4)
    whole = ctl.run_device(stream)
    chunked = ctl.run_device(stream, chunk_events=17)
    assert_bit_parity(whole, chunked)


def test_device_rejects_scored_admission():
    stream = stream_of(3, 600.0, rate=0.1)
    ctl = StreamController(SP(), B, max_live=4,
                           admission=AdmissionController(SP(), B=B,
                                                         agreeable="rank"))
    with pytest.raises(ValueError, match="admission"):
        ctl.run_device(stream)


def test_event_arrays_encode_the_host_order():
    # arrivals before budget steps at equal times, the end last; an
    # all-zero row is a pad event (kind 0)
    stream = P.arrival_stream_from_log([1.0, 3.0], [2.0, 1.0],
                                       horizon=10.0, budget_times=[1.0],
                                       budget_values=[5.0])
    t_e, kind, pi, pf = _event_arrays(stream)
    np.testing.assert_array_equal(t_e, [1.0, 1.0, 3.0, 10.0])
    np.testing.assert_array_equal(kind, [1, 2, 1, 3])
    np.testing.assert_array_equal(pi, [0, 0, 1, 0])
    np.testing.assert_array_equal(pf, [0.0, 5.0, 0.0, 0.0])
    assert not np.any(kind == 0)
