"""The cascade's escalations on the device event loop.

Two traces on which the device loop leaves the warm path, each held bit
for bit to the host loop with the same ``StreamCascadePolicy``, and to
the JAX package's ``run_device`` (the same counts, completions and J to
1e-9):

  * random weights (seed 9, M = 8): the fresh ranking fails the
    certificate again and again and the exchange search rescues it.
    The reference's own test samples this trace over 2400 s; here over
    300 s (115 arrivals, 92 escalations, 23 on the ladder), which keeps
    the file within a minute on one CPU worker;
  * the quick day trace's settings with slowdown weights (seed 8, 2 h,
    rate 0.12, four budget steps, M = 8): the cascade's own ladder
    fires once (``degraded_windows == 1``), as it does three times on
    the reference's 24-hour day (``BENCH_serve.json``).  The seed was
    found with the JAX package's ``run_device``: no 1-hour trace of
    seeds 0–39 degrades, and seed 8 is the first 2-hour one that does.
"""
import numpy as np

from test_torch_stream_device import (assert_bit_parity, assert_matches_jax,
                                      cascade, jax_run_device, stream_of)


def test_search_branch_exercised_and_identical():
    stream = stream_of(9, 300.0, rate=0.35, weights="random")
    ctl = cascade(8)
    host = ctl.run(stream)
    assert host.cold_replans > 0 and ctl.policy.order_searches > 0
    dev = ctl.run_device(stream)
    assert_bit_parity(host, dev)
    assert_matches_jax(dev, jax_run_device(stream, 8))


def test_ladder_fires_on_a_two_hour_day_trace():
    stream = stream_of(8, 7200.0, rate=0.12, n_budget_events=4,
                       deadline_slack=50.0)
    dev = cascade(8).run_device(stream)
    assert dev.degraded_windows == 1
    assert dev.metrics.n_completed == dev.metrics.n_arrivals
    assert_matches_jax(dev, jax_run_device(stream, 8))
    assert np.isfinite(dev.completion).all()
