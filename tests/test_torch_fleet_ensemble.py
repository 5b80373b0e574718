"""Port vs JAX: the fleet layer's ensemble runner
(``distributed/fleet.py::simulate_ensemble_sharded``) at D = 1, 2, 8, and
admission's simulate estimator under a fleet mesh.

As in ``test_torch_fleet.py``: every case runs on CPU meshes of 1, 2 and
8 shards of the host device and is held with ``torch.equal`` to the
port's unsharded ``simulate_ensemble`` (J, T, finished, n_events,
exhausted), in float64 and in float32; the port's unsharded float64 run
is held to the JAX package's at the reference's tolerances (J and T
1e-6, the same ``n_events``) on the same numpy inputs.  Padded workloads
(size-0 jobs, edge-replicated fault traces) halt before their first
event.
"""
import numpy as np
import pytest
import torch

import repro.core as J
import repro.sched.policies as JP
import repro_torch.core as P
import repro_torch.robust as PR
import repro_torch.sched.policies as PP
from repro_torch.distributed import fleet_mesh, simulate_ensemble_sharded
from test_torch_fleet import (B, DS, K, SIM_FIELDS, _SPS, _equal, _sim_vs_jax,
                              _workloads, chunk, mesh)
from torch_port_util import np_, port_speedup


def _ensemble_policies(mod, sp):
    return (mod.SmartFillPolicy(sp, B=B), mod.HeSRPTPolicy(0.5, B),
            mod.EquiPolicy(B))


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_ensemble_parity(dtype):
    X, W, wl = _workloads(6, arrival_rate=0.5)
    spj = _SPS["regular"]()
    sp = port_speedup(spj)
    args = (X, W)
    arr = wl.arrival
    if dtype == "f32":
        sp = P.speedup.map_leaves(sp, lambda l: l.float())
        args = tuple(torch.tensor(a, dtype=torch.float32) for a in args)
        arr = torch.tensor(arr, dtype=torch.float32)
    pols = _ensemble_policies(PP, sp)
    ref = P.simulate_ensemble(sp, pols, *args, arrival=arr, B=B)
    for D in DS:
        sh = simulate_ensemble_sharded(sp, pols, *args, arrival=arr, B=B,
                                       mesh=mesh(D), chunk_size=chunk(D, 8))
        assert sh.J.dtype == ref.J.dtype
        _equal(sh, ref, SIM_FIELDS)
        assert sh.policy_names == ref.policy_names
    if dtype == "f64":
        _sim_vs_jax(ref, J.simulate_ensemble(
            spj, _ensemble_policies(JP, spj), X, W, arrival=wl.arrival, B=B))


def test_ensemble_parity_batched_speedups():
    """Per-workload speedup params + per-workload policy budgets shard."""
    X, W, wl = _workloads(7, family=("power", "log"))
    Bv = np.linspace(8.0, 12.0, K)
    sp = port_speedup(wl.sp)
    pols = (PP.EquiPolicy(B=Bv), PP.HeSRPTPolicy(0.5, B=Bv))
    ref = P.simulate_ensemble(sp, pols, X, W)
    for D in DS:
        _equal(simulate_ensemble_sharded(sp, pols, X, W, mesh=mesh(D)), ref,
               SIM_FIELDS)
    _sim_vs_jax(ref, J.simulate_ensemble(
        wl.sp, (JP.EquiPolicy(B=Bv), JP.HeSRPTPolicy(0.5, B=Bv)), X, W))


def test_admission_simulate_estimator_sharded():
    from repro.serve.admission import AdmissionController as JAdmission
    from repro_torch.serve.admission import AdmissionController

    spj = _SPS["log"]()
    sp = port_speedup(spj)
    rs = np.array([8.0, 4.0])
    cs_ = np.array([6.0, 2.0, 1.0])
    args = (rs, 1.0 / rs, cs_, 1.0 / cs_)
    ac = AdmissionController(sp, estimator="simulate")
    ref = ac.evaluate(*args)
    for D in DS:
        with fleet_mesh(D, device="cpu"):
            sh = ac.evaluate(*args)
        np.testing.assert_array_equal(sh.marginal_cost, ref.marginal_cost)
        np.testing.assert_array_equal(sh.admit, ref.admit)
        sh = AdmissionController(sp, estimator="simulate",
                                 mesh=mesh(D)).evaluate(*args)
        np.testing.assert_array_equal(sh.marginal_cost, ref.marginal_cost)
    jref = JAdmission(spj, estimator="simulate").evaluate(*args)
    np.testing.assert_allclose(ref.marginal_cost, jref.marginal_cost,
                               rtol=1e-6, atol=1e-6)


def test_ensemble_parity_hetero_policies():
    """HeteroSmartFillPolicy + the retired WMR baseline shard with their
    (K, M) per-job leaves through the ensemble runner."""
    X, W, wl = _workloads(12, k=9, m=4,
                          family=("power", "log", "saturating"),
                          per_job=True)
    sp = port_speedup(wl.sp)
    pols = (PP.HeteroSmartFillPolicy(sp, B=B),
            PP.WeightedMarginalRatePolicy(sp, B=B))
    ref = P.simulate_ensemble(sp, pols, X, W, B=B)
    for D in DS:
        _equal(simulate_ensemble_sharded(sp, pols, X, W, B=B, mesh=mesh(D)),
               ref, SIM_FIELDS)
    jref = J.simulate_ensemble(wl.sp, (JP.HeteroSmartFillPolicy(wl.sp, B=B),
                                       JP.WeightedMarginalRatePolicy(wl.sp,
                                                                     B=B)),
                               X, W, B=B)
    np.testing.assert_allclose(np_(ref.J), np.asarray(jref.J), rtol=1e-6)
    np.testing.assert_array_equal(np_(ref.finished),
                                  np.asarray(jref.finished))


def test_ensemble_parity_faulted():
    """Fault ensembles shard like workloads: per-instance chaos traces
    ride the mesh and the sharded faulted run equals the single-device
    faulted run exactly (including the all-padding instance, which must
    halt before consuming any fault)."""
    X, W, _ = _workloads(21, k=9, m=4)
    spj = _SPS["regular"]()
    sp = port_speedup(spj)
    kw = dict(B=B, horizon=4.0, preempt_rate=0.8, fail_rate=0.5,
              straggle_rate=0.5)
    traces = P.sample_fault_traces(22, 9, 4, **kw)
    traces_j = J.sample_fault_traces(22, 9, 4, **kw)
    pols = (PP.SmartFillPolicy(sp, B=B), PP.EquiPolicy(B))
    ref = P.simulate_ensemble(sp, pols, X, W, faults=traces)
    for D in DS:
        _equal(simulate_ensemble_sharded(sp, pols, X, W, faults=traces,
                                         mesh=mesh(D), chunk_size=chunk(D, 4)),
               ref, SIM_FIELDS)
    _sim_vs_jax(ref, J.simulate_ensemble(
        spj, (JP.SmartFillPolicy(spj, B=B), JP.EquiPolicy(B)), X, W,
        faults=traces_j))

    # a shared 1-D trace broadcasts to every lane identically too
    bt = P.budget_trace([0.5, 1.5], [3.0, B])
    ref1 = P.simulate_ensemble(sp, pols, X, W, faults=bt)
    for D in DS:
        _equal(simulate_ensemble_sharded(sp, pols, X, W, faults=bt,
                                         mesh=mesh(D)), ref1, SIM_FIELDS)


def test_degrading_ladder_shards_with_per_lane_rungs():
    """A ladder with per-workload rung budgets and a sabotaged primary
    shards like any policy: its rungs' (K,) leaves split with their
    workloads, and the result is the unsharded ladder's bit for bit."""
    X, W, _ = _workloads(15, m=5)
    sp = port_speedup(_SPS["log"]())
    Bv = np.linspace(8.0, 12.0, K)
    lad = PR.DegradingPolicy(rungs=(
        PR.SaboteurPolicy(PP.SmartFillPolicy(sp, B=Bv), mode="overspend",
                          min_active=3),
        PP.GWFStaticPolicy(sp, B=Bv), PP.EquiPolicy(B=Bv)))
    ref = P.simulate_ensemble(sp, (lad,), X, W)
    assert bool(ref.finished.all())
    for D in DS:
        _equal(simulate_ensemble_sharded(sp, (lad,), X, W, mesh=mesh(D),
                                         chunk_size=chunk(D, 5)),
               ref, SIM_FIELDS)

