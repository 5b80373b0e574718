"""Port vs JAX: the fleet's multi-tenant stream service
(``distributed/fleet.py``: ``serve_streams_sharded``, ``FleetStreamResult``).

Tenant i through the sharded fleet equals tenant i solo through
``StreamController.run_device`` bit for bit — completions, every replan
counter and the metrics — under per-tenant budgets and a nonzero plan
latency, on CPU meshes of 1, 2 and 8 shards of the host (T = 3 does not
divide 2 or 8, so padded inert tenants ride along).  The cross-tenant
admission view (backlog, unfinished work, the advisory budget share) is
held to the JAX package's on the same numpy streams.
"""
import functools

import numpy as np
import pytest

import repro.core as J
import repro.distributed as JD
import repro_torch.core as P
from repro_torch.core.speedup import map_leaves
from repro_torch.distributed import (FleetStreamResult, fleet_mesh,
                                     serve_streams_sharded)
from repro_torch.serve import StreamCascadePolicy, StreamController
from torch_port_util import jax_sharded

B = 10.0
BUDGETS = [10.0, 8.0, 12.0]


def SP():
    return P.power(1.0, 0.5, B, device="cpu")


def tenant_streams(seeds, horizon=900.0, rate=0.2, **kw):
    return [P.sample_arrival_stream(s, horizon=horizon, rate=rate,
                                    diurnal=0.75, period=horizon, B=B,
                                    n_budget_events=2,
                                    budget_frac=(0.3, 0.8), **kw)
            for s in seeds]


@functools.lru_cache(maxsize=None)
def solo_runs():
    """The three tenants of the parity case, each solo through
    ``run_device`` (one budget each, plan latency 1.0)."""
    streams = tenant_streams((3, 7, 11), weights="random")
    out = []
    for strm, b in zip(streams, BUDGETS):
        ctl = StreamController(SP(), b, max_live=5,
                               policy=StreamCascadePolicy(SP(), b),
                               plan_latency=1.0)
        out.append(ctl.run_device(strm))
    return streams, out


@pytest.mark.parametrize("D", (1, 2, 8))
def test_serve_streams_sharded_matches_solo_run_device(D):
    streams, solo = solo_runs()
    fleet = serve_streams_sharded(SP(), streams, budgets=BUDGETS,
                                  max_live=5, plan_latency=1.0,
                                  mesh=fleet_mesh(D, device="cpu"))
    assert isinstance(fleet, FleetStreamResult) and len(fleet) == 3
    for got, ref in zip(fleet.results, solo):
        np.testing.assert_array_equal(got.completion, ref.completion)
        for f in ("replans", "warm_replans", "cold_replans",
                  "degraded_windows", "n_events"):
            assert getattr(got, f) == getattr(ref, f), f
        assert got.metrics == ref.metrics
    # every tenant drained: the view is uniform
    np.testing.assert_array_equal(fleet.backlog, np.zeros(3, int))
    np.testing.assert_array_equal(fleet.suggested_budget_share,
                                  np.full(3, 1.0 / 3))


def test_serve_streams_sharded_admission_view_matches_jax():
    # an overloaded, starved tenant carries the backlog and is advised
    # the larger share of the next budget round
    streams = (tenant_streams((5, 6), horizon=600.0, rate=0.05)
               + tenant_streams((8,), horizon=600.0, rate=1.5))
    budgets = [B, B, 0.5]
    fleet = serve_streams_sharded(SP(), streams, budgets=budgets,
                                  max_live=4, mesh=fleet_mesh(2,
                                                              device="cpu"))
    ref = jax_sharded(JD.serve_streams_sharded, J.power(1.0, 0.5, B),
                      streams, budgets=budgets, max_live=4,
                      mesh=JD.fleet_mesh())
    np.testing.assert_array_equal(fleet.backlog, ref.backlog)
    np.testing.assert_allclose(fleet.unfinished_work, ref.unfinished_work,
                               rtol=1e-9)
    np.testing.assert_allclose(fleet.suggested_budget_share,
                               ref.suggested_budget_share, rtol=1e-9)
    np.testing.assert_array_equal(fleet.deadline_misses,
                                  ref.deadline_misses)
    np.testing.assert_allclose(fleet.mean_slowdown, ref.mean_slowdown,
                               rtol=1e-9)
    np.testing.assert_allclose(fleet.p99_latency, ref.p99_latency,
                               rtol=1e-9)
    for got, r in zip(fleet.results, ref.results):
        assert (got.replans, got.n_events, got.metrics.n_completed) == (
            r.replans, r.n_events, r.metrics.n_completed)
    share = fleet.suggested_budget_share
    np.testing.assert_allclose(share.sum(), 1.0)
    assert fleet.backlog[2] > 0 and share[2] == share.max()
    assert fleet.unfinished_work[2] > fleet.unfinished_work[:2].max()


def test_serve_streams_sharded_validates():
    streams = tenant_streams((1,))
    mesh = fleet_mesh(1, device="cpu")
    with pytest.raises(ValueError, match="tenant"):
        serve_streams_sharded(SP(), [], mesh=mesh)
    with pytest.raises(ValueError, match="budget"):
        serve_streams_sharded(SP(), streams, budgets=[B, B], mesh=mesh)
    with pytest.raises(ValueError, match="max_live"):
        serve_streams_sharded(SP(), streams, max_live=0, mesh=mesh)
    wl = P.sample_workloads(0, K=2, M=4, B=B, per_job=True,
                            family=("power", "log"), device="cpu")
    sp_pj = map_leaves(wl.sp, lambda l: l[0])
    with pytest.raises(ValueError, match="shared scalar-leaf"):
        serve_streams_sharded(sp_pj, streams, mesh=mesh)


def test_fleet_exports():
    import repro_torch.distributed as D
    for name in ("FleetStreamResult", "serve_streams_sharded"):
        assert name in D._FLEET_EXPORTS and name in dir(D)
        assert getattr(D, name) is not None
    assert D.serve_streams_sharded is serve_streams_sharded
