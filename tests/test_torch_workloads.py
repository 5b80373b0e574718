"""Port vs JAX: the seeded workload samplers, bit for bit.

``sample_workloads`` and ``sample_arrival_stream`` draw everything with
numpy from one seed, so the port's copies must give the JAX package's
arrays exactly: sizes, weights, arrival times, live counts, every
speedup leaf, deadlines and budget steps.  The arrival-log loaders must
read the same logs into the same streams (the recorded sample in
``benchmarks/traces``, which they only read, and a JSON copy).
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.workloads as J_wl
import repro_torch.core as P
from torch_port_util import np_

B = 10.0
CASES = {
    "no_family": dict(),
    "one_family": dict(family="log"),
    "five_family_mix": dict(family=P.FAMILIES),
    "per_job_m_range": dict(family=P.FAMILIES, per_job=True, m_range=(2, 7)),
    "random_weights": dict(family="shifted", weights="random",
                           m_range=(1, 7)),
    "arrivals": dict(arrival_rate=0.5, m_range=(3, 7)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sample_workloads_bitwise(case):
    kw = CASES[case]
    ref = J.sample_workloads(17, K=9, M=7, B=B, **kw)
    out = P.sample_workloads(17, K=9, M=7, B=B, device="cpu", **kw)
    for key in ("X", "W", "arrival", "m"):
        assert np.array_equal(getattr(out, key), getattr(ref, key)), key
    assert out.B == ref.B and len(out) == len(ref)
    assert np.array_equal(out.active, ref.active)
    if ref.sp is None:
        assert out.sp is None
        return
    assert type(out.sp).__name__ == type(ref.sp).__name__
    for name in ("A", "w", "gamma"):
        leaf = getattr(out.sp, name)
        assert leaf.dtype == torch.float64 and leaf.device.type == "cpu"
        assert np.array_equal(np_(leaf), np.asarray(getattr(ref.sp, name)))
    sig = out.sp.sigma
    assert np.array_equal(np_(sig) if isinstance(sig, torch.Tensor)
                          else np.asarray(sig), np.asarray(ref.sp.sigma))


def test_the_families_and_their_errors():
    assert P.FAMILIES == J.FAMILIES
    with pytest.raises(ValueError, match="unknown speedup family"):
        P.sample_workloads(0, K=2, M=3, family="cubic", device="cpu")
    with pytest.raises(ValueError, match="m_range"):
        P.sample_workloads(0, K=2, M=3, m_range=(0, 3))
    with pytest.raises(ValueError, match="weights"):
        P.sample_workloads(0, K=2, M=3, weights="uniform")


def test_stack_speedup_rows_matches_jax():
    from repro.core.speedup import stack_speedup_rows as rows_j
    members = [J.log_speedup(1.0, 1.0, B), J.saturating(1.0, 12.0, 2.0, B),
               J.neg_power(1.0, 1.0, -1.0, B)]
    from torch_port_util import port_speedup
    port_members = [port_speedup(s) for s in members]
    rows = [members[:2], [], members]
    ref = rows_j(rows, 4, B)
    out = P.stack_speedup_rows([port_members[:2], [], port_members], 4, B)
    for name in ("A", "w", "gamma", "sigma"):
        assert np.array_equal(np_(getattr(out, name)),
                              np.asarray(getattr(ref, name)))
    with pytest.raises(ValueError, match="slots"):
        P.stack_speedup_rows([port_members], 2, B)


STREAM_CASES = {
    "defaults": dict(),
    "short_random": dict(horizon=5000.0, rate=0.05, weights="random"),
    "uniform_flat": dict(horizon=2000.0, rate=0.1, diurnal=0.0,
                         weights="uniform", size_range=(1.0, 3.0)),
    "deadlines_budgets": dict(horizon=4000.0, rate=0.15, B=8.0,
                              n_budget_events=4, deadline_slack=60.0,
                              solo_rate=2.5, period=1000.0),
    "budget_frac": dict(horizon=3000.0, rate=0.02, n_budget_events=9,
                        budget_frac=(0.1, 0.2)),
}
STREAM_KEYS = ("t", "x", "w", "deadline", "budget_times", "budget_values")


def _same_stream(out, ref):
    assert type(out).__name__ == "ArrivalStream"
    for key in STREAM_KEYS:
        a, r = getattr(out, key), getattr(ref, key)
        assert a.dtype == r.dtype and np.array_equal(a, r), key
    assert out.horizon == ref.horizon and len(out) == len(ref)


@pytest.mark.parametrize("case", list(STREAM_CASES))
def test_sample_arrival_stream_bitwise(case):
    kw = STREAM_CASES[case]
    _same_stream(P.sample_arrival_stream(42, **kw),
                 J.sample_arrival_stream(42, **kw))


def test_arrival_stream_errors():
    for kw, msg in ((dict(horizon=0.0), "horizon"),
                    (dict(diurnal=1.5), "diurnal"),
                    (dict(weights="cubic"), "weights")):
        with pytest.raises(ValueError, match=msg):
            P.sample_arrival_stream(0, **kw)
    for args, kw, msg in (
            (([0.0, 1.0], [1.0]), {}, "same length"),
            (([0.0, np.inf], [1.0, 1.0]), {}, "finite"),
            (([0.0], [0.0]), {}, "positive"),
            (([0.0], [1.0], [-1.0]), {}, "positive"),
            (([0.0], [1.0], [1.0, 2.0]), {}, "match times"),
            (([0.0], [1.0]), dict(budget_times=[1.0]), "must match"),
            (([0.0, 5.0], [1.0, 1.0]), dict(horizon=5.0), "strictly before")):
        with pytest.raises(ValueError, match=msg):
            P.arrival_stream_from_log(*args, **kw)
        with pytest.raises(ValueError, match=msg):
            J_wl.arrival_stream_from_log(*args, **kw)


LOG = Path(__file__).resolve().parents[1] / "benchmarks" / "traces" / \
    "arrivals_sample.csv"


def test_load_arrival_log_csv_and_json(tmp_path):
    ref = J_wl.load_arrival_log(LOG)
    out = P.load_arrival_log(LOG)
    _same_stream(out, ref)
    assert out.budget_times.size == 4 and len(out) > 100
    blob = {"t": ref.t[::-1].tolist(), "x": ref.x[::-1].tolist(),
            "deadline": [1e9] * len(ref), "horizon": 2000.0,
            "budget_times": [300.0, 100.0], "budget_values": [4.0, 6.0]}
    path = tmp_path / "log.json"
    path.write_text(json.dumps(blob))
    _same_stream(P.load_arrival_log(path), J_wl.load_arrival_log(path))
    # the sampler's replay entry point is the log constructor
    assert P.sample_arrival_stream.from_log is P.arrival_stream_from_log
    _same_stream(P.sample_arrival_stream.from_log([3.0, 1.0, 2.0],
                                                  [1.0, 2.0, 4.0]),
                 J_wl.arrival_stream_from_log([3.0, 1.0, 2.0], [1.0, 2.0, 4.0]))
    bad = tmp_path / "bad.csv"
    bad.write_text("time,size\n1,2\n")
    with pytest.raises(ValueError, match="'t' and 'x'"):
        P.load_arrival_log(bad)
    empty = tmp_path / "empty.csv"
    empty.write_text("# only a comment\n")
    with pytest.raises(ValueError, match="no header"):
        P.load_arrival_log(empty)


CLASS_CASES = {
    "random_weights": dict(),
    "slowdown_weights": dict(weights="slowdown"),
    "family_subset": dict(family=("power", "log", "neg_power"),
                          count_range=(1, 9)),
    "all_empty_rerolled": dict(count_range=(0, 0)),
}


@pytest.mark.parametrize("case", list(CLASS_CASES))
def test_sample_class_workloads_bitwise(case):
    """Counts, sizes, weights and the (K, C) family leaves equal to the
    reference's bit for bit; ``.state(k)`` gives instance k's state."""
    kw = CLASS_CASES[case]
    ref = J.sample_class_workloads(11, K=7, C=5, B=B, **kw)
    out = P.sample_class_workloads(11, K=7, C=5, B=B, device="cpu", **kw)
    for key in ("counts", "sizes", "weights"):
        assert np.array_equal(getattr(out, key), getattr(ref, key)), key
    assert out.B == ref.B and len(out) == len(ref) == 7
    assert np.array_equal(out.jobs, ref.jobs)
    assert type(out.sp).__name__ == type(ref.sp).__name__
    for name in ("A", "w", "gamma", "sigma"):
        leaf = getattr(out.sp, name)
        ref_leaf = np.asarray(getattr(ref.sp, name))
        got = np_(leaf) if isinstance(leaf, torch.Tensor) else np.asarray(leaf)
        assert np.array_equal(got, ref_leaf), name
    for k in (0, 6):
        st, st_ref = out.state(k), ref.state(k)
        assert isinstance(st, P.ClassState) and st.C == 5
        assert np.array_equal(st.counts, st_ref.counts)
        assert np.array_equal(np_(st.sp.A), np.asarray(st_ref.sp.A))
        assert st.B == B


def test_sample_class_workloads_errors():
    with pytest.raises(ValueError, match="count_range"):
        P.sample_class_workloads(0, K=2, C=3, count_range=(3, 1),
                                 device="cpu")
    with pytest.raises(ValueError, match="weights"):
        P.sample_class_workloads(0, K=2, C=3, weights="equal", device="cpu")
    with pytest.raises(ValueError, match="unknown speedup family"):
        P.sample_class_workloads(0, K=2, C=3, family="cubic", device="cpu")
