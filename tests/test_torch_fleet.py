"""Port vs JAX: the fleet layer (``distributed/fleet.py``) at D = 1, 2, 8.

The fleet layer's contract is *parity*: ``plan_sharded`` reproduces
``smartfill_batched`` and ``simulate_ensemble_sharded`` reproduces
``simulate_ensemble`` instance by instance — sharding is a layout
decision, never a numerical one.  In the port that holds bit for bit:
every case runs on CPU meshes of 1, 2 and 8 shards of the host device
(the JAX package's forced-host-devices layout: K = 19 instances pad to
a multiple of D and of the chunk, padded rows are inert) and is held
with ``torch.equal`` to the port's unsharded call, in float64 and in
float32.  The port's unsharded float64 call is in turn held to the JAX
package's at the reference's tolerances (J and T 1e-6, the same
``n_events``), on the same numpy inputs.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.distributed as JD
import repro_torch.core as P
import repro_torch.sched.policies as PP
from repro_torch.distributed import (FleetMesh, active_fleet_mesh,
                                     active_mesh, fleet_mesh,
                                     plan_classes_sharded, plan_sharded,
                                     simulate_ensemble_sharded)
from repro_torch.distributed.fleet import _chunk_layout
from torch_port_util import jax_sharded, np_, port_speedup

B = 10.0
K = 19          # deliberately not a multiple of any mesh size here
M = 6
DS = (1, 2, 8)

_SPS = {
    "regular": lambda: J.shifted_power(1.0, 4.0, 0.5, B),
    "log": lambda: J.log_speedup(1.0, 1.0, B),
}

PLAN_FIELDS = ("theta", "c", "a", "durations", "T", "J", "J_linear", "m",
               "active")
SIM_FIELDS = ("J", "T", "finished", "n_events", "exhausted")


def mesh(D):
    return fleet_mesh(D, device="cpu")


def chunk(D, size):
    """The chunk size a costly case runs at on a D-shard mesh: chunked
    streaming on one shard, one chunk over several (each layout once)."""
    return size if D == 1 else None


def _workloads(seed=0, k=K, m=M, **kw):
    wl = J.sample_workloads(seed, K=k, M=m, B=B, m_range=(1, m), **kw)
    X, W = wl.X.copy(), wl.W.copy()
    X[-1] = 0.0          # one all-padding instance (m = 0) in every batch
    W[-1] = 0.0
    return X, W, wl


def _equal(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and torch.equal(x, y), f


def _plan_vs_jax(got, ref):
    """The reference's float64 plan parity (tests/distributed/test_fleet.py)."""
    np.testing.assert_allclose(np_(got.J), np.asarray(ref.J), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(np_(got.T), np.asarray(ref.T), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(np_(got.theta), np.asarray(ref.theta),
                               atol=1e-6)
    np.testing.assert_array_equal(np_(got.m), np.asarray(ref.m))


def _sim_vs_jax(got, ref):
    np.testing.assert_array_equal(np_(got.finished), np.asarray(ref.finished))
    fin = np.asarray(ref.finished)
    np.testing.assert_allclose(np.where(fin, np_(got.J), 0.0),
                               np.where(fin, np.asarray(ref.J), 0.0),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(np_(got.T), np.asarray(ref.T), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(np_(got.n_events), np.asarray(ref.n_events))
    assert got.policy_names == ref.policy_names


@functools.lru_cache(maxsize=None)
def _jax_plan(family, seed):
    X, W, _ = _workloads(seed)
    return J.smartfill_batched(_SPS[family](), X, W, B=B)


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("family", sorted(_SPS))
def test_plan_parity_f64(family, D):
    X, W, _ = _workloads(0)
    sp = port_speedup(_SPS[family]())
    ref = P.smartfill_batched(sp, X, W, B=B)
    sh = plan_sharded(sp, X, W, B=B, mesh=mesh(D))
    assert sh.theta.dtype == torch.float64
    _equal(sh, ref, PLAN_FIELDS)
    _plan_vs_jax(ref, _jax_plan(family, 0))


@pytest.mark.parametrize("D", DS)
@pytest.mark.parametrize("family", sorted(_SPS))
def test_plan_parity_f32(family, D):
    """float32 in torch dtypes: the sharded call is the unsharded float32
    call bit for bit (the JAX package's own float32 parity cases cannot
    run on this jax line); and it lands within the reference's float32
    J tolerance of the float64 plan."""
    X, W, _ = _workloads(1)
    sp = port_speedup(_SPS[family]())
    sp32 = P.speedup.map_leaves(sp, lambda l: l.float())
    X32, W32 = torch.tensor(X, dtype=torch.float32), \
        torch.tensor(W, dtype=torch.float32)
    ref = P.smartfill_batched(sp32, X32, W32, B=B)
    sh = plan_sharded(sp32, X32, W32, B=B, mesh=mesh(D), chunk_size=8)
    assert sh.theta.dtype == torch.float32
    _equal(sh, ref, PLAN_FIELDS)
    f64 = P.smartfill_batched(sp, X, W, B=B)
    np.testing.assert_allclose(np_(sh.J), np_(f64.J), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("D", DS)
def test_plan_parity_chunked(D):
    """Sweeps larger than memory: scanning bounded chunks changes
    nothing, including chunks smaller than the mesh and non-divisors."""
    X, W, _ = _workloads(2)
    sp = port_speedup(_SPS["log"]())
    ref = P.smartfill_batched(sp, X, W, B=B)
    layouts = {}
    for size in (1, 4, 7, K):           # each distinct padding layout once
        layouts.setdefault(_chunk_layout(K, D, size), size)
    for size in layouts.values():
        sh = plan_sharded(sp, X, W, B=B, mesh=mesh(D), chunk_size=size)
        _equal(sh, ref, PLAN_FIELDS)
    _plan_vs_jax(ref, _jax_plan("log", 2))


def test_vpow_bits_do_not_depend_on_the_batch():
    """The CPU's pow rounds its vector lanes and its scalar tail loop
    differently; ``vpow`` gives every element the scalar (libm) pow, so
    an element has the same bits alone and in any batch, and the
    operator's dtype rules hold."""
    import math

    from repro_torch._device import vpow

    rng = np.random.default_rng(0)
    x = torch.tensor(rng.uniform(0.1, 10.0, 1000))
    g = torch.tensor(rng.uniform(-1.5, -0.5, 1000))
    full = vpow(x, g)
    alone = torch.stack([vpow(x[i:i + 1], g[i:i + 1])[0]
                         for i in range(1000)])
    assert torch.equal(full, alone)
    assert full.tolist() == [math.pow(a, b)
                             for a, b in zip(x.tolist(), g.tolist())]
    assert torch.equal(vpow(x, 0.37), torch.stack(
        [vpow(x[i:i + 1], 0.37)[0] for i in range(1000)]))
    assert torch.equal(vpow(10.0, x[:5]), 10.0 ** x[:5])
    assert vpow(x.float(), torch.tensor(2.0, dtype=torch.float64)).dtype \
        == torch.float32
    assert vpow(x[:6].reshape(2, 3), g[:3]).shape == (2, 3)


def test_chunk_layout():
    assert _chunk_layout(19, 8, None) == (24, 1, 24)
    assert _chunk_layout(19, 8, 7) == (24, 3, 8)
    assert _chunk_layout(1000, 1, 192) == (1152, 6, 192)
    assert _chunk_layout(3, 8, None) == (8, 1, 8)
    with pytest.raises(ValueError):
        _chunk_layout(0, 1, None)
    with pytest.raises(ValueError):
        _chunk_layout(5, 1, 0)


@pytest.mark.parametrize("D", DS)
def test_plan_parity_batched_speedups(D):
    """Per-instance RegularSpeedup leaves shard alongside their instance."""
    X, W, wl = _workloads(3, family=("power", "shifted", "log", "neg_power"))
    sp = port_speedup(wl.sp)
    ref = P.smartfill_batched(sp, X, W, B=B)
    sh = plan_sharded(sp, X, W, B=B, mesh=mesh(D), chunk_size=8)
    _equal(sh, ref, PLAN_FIELDS)
    if D == 1:
        _plan_vs_jax(ref, J.smartfill_batched(wl.sp, X, W, B=B))


def test_plan_parity_per_instance_budgets():
    X, W, _ = _workloads(4)
    Bv = np.linspace(6.0, 14.0, K)
    sp = port_speedup(_SPS["regular"]())
    ref = P.smartfill_batched(sp, X, W, B=Bv)
    for D in DS:
        _equal(plan_sharded(sp, X, W, B=Bv, mesh=mesh(D)), ref, PLAN_FIELDS)
    _plan_vs_jax(ref, J.smartfill_batched(_SPS["regular"](), X, W, B=Bv))


def test_plan_padded_outputs_inert():
    """Mesh-padding instances never leak: the returned arrays are trimmed
    back to N and the m = 0 instance is exact zeros."""
    X, W, _ = _workloads(5)
    sp = port_speedup(_SPS["log"]())
    for D in DS:
        sh = plan_sharded(sp, X, W, B=B, mesh=mesh(D), chunk_size=5)
        assert sh.theta.shape[0] == K
        assert float(sh.theta[-1].abs().max()) == 0.0
        assert float(sh.J[-1]) == 0.0
        assert bool(torch.isfinite(sh.theta).all())


def test_small_K_pads_up_to_device_count():
    """K < device count: everything pads, results still exact."""
    X, W, _ = _workloads(8, k=3)
    sp = port_speedup(_SPS["log"]())
    ref = P.smartfill_batched(sp, X, W, B=B)
    sh = plan_sharded(sp, X, W, B=B, mesh=mesh(8))
    _equal(sh, ref, PLAN_FIELDS)
    _plan_vs_jax(sh, J.smartfill_batched(_SPS["log"](), X, W, B=B))


def test_mesh_context_dispatch():
    """active_fleet_mesh: 1-D contexts are ours, multi-axis are not; the
    innermost context wins and leaving it restores the outer one."""
    assert active_fleet_mesh() is None and active_mesh() is None
    devs = np.asarray([torch.device("cpu")] * 2, dtype=object)
    with FleetMesh(devs, ("fleet",)) as m:
        got = active_fleet_mesh()
        assert got is m and got.axis_names == ("fleet",)
        assert got.devices.size == 2 and got.shape == {"fleet": 2}
        with FleetMesh(devs.reshape(-1, 1), ("data", "model")) as m2:
            assert active_mesh() is m2 and active_fleet_mesh() is None
        assert active_fleet_mesh() is m
    assert active_fleet_mesh() is None
    with pytest.raises(ValueError, match="axis names"):
        FleetMesh(devs, ("data", "model"))
    with pytest.raises(ValueError, match="1-D mesh"):
        plan_sharded(port_speedup(_SPS["log"]()), *_workloads(0)[:2], B=B,
                     mesh=FleetMesh(devs.reshape(-1, 1), ("data", "model")))


def test_fleet_mesh_defaults_to_cuda():
    """An entry point asked for no device runs on the card: without one
    it raises, as every other entry point of the port does; the CPU mesh
    is the caller's explicit choice."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            fleet_mesh()
    m = fleet_mesh(device="cpu")
    assert m.size == 1 and m.axis_names == ("fleet",)
    # without a mesh the sharded call runs on its inputs' device
    X, W, _ = _workloads(0, k=4)
    sp = port_speedup(_SPS["log"]())
    sh = plan_sharded(sp, X, W, B=B)
    assert sh.J.device.type == "cpu"


def test_plan_parity_hetero_per_job_speedups():
    """§7 fleets shard: per-job (N, M) speedup leaves split along the
    instance axis, padded rows edge-replicate valid family params, and
    the sharded result equals the single-device per-job solve."""
    X, W, wl = _workloads(
        11, family=("power", "shifted", "log", "neg_power", "saturating"),
        per_job=True)
    sp = port_speedup(wl.sp)
    ref = P.smartfill_batched(sp, X, W, B=B)
    for D in DS:
        _equal(plan_sharded(sp, X, W, B=B, mesh=mesh(D),
                            chunk_size=chunk(D, 8)), ref, PLAN_FIELDS)
    _plan_vs_jax(ref, J.smartfill_batched(wl.sp, X, W, B=B))


def test_padded_rows_do_not_hold_the_cpu_loops(monkeypatch):
    """On the CPU a padded (m = 0) row counts as done from the start: a
    per-job plan with 16 padded rows runs its descent loop as many steps
    as the plan without them, and with the same bits."""
    import sys

    S = sys.modules["repro_torch.core.smartfill"]
    steps = []
    real = S.stops_early

    def counting(frozen, sync=False):
        steps[-1] += 1
        return real(frozen, sync)

    monkeypatch.setattr(S, "stops_early", counting)
    X, W, wl = _workloads(16, k=8, family=("power", "log", "saturating"),
                          per_job=True)
    sp = port_speedup(wl.sp)
    steps.append(0)
    ref = P.smartfill_batched(sp, X, W, B=B)
    steps.append(0)
    sh = plan_sharded(sp, X, W, B=B, mesh=mesh(1), chunk_size=24)
    assert steps[0] == steps[1] > 0
    _equal(sh, ref, PLAN_FIELDS)


def test_shared_per_job_leaf_with_a_slice_of_M_rows():
    """A shared job-indexed (M,) leaf stays per job in a slice that
    happens to hold M rows (where an (M,) leaf would read as one value
    an instance): K = 12 over 2 shards of M = 6 rows."""
    wl = J.sample_workloads(13, K=12, M=M, B=B, m_range=(2, M))
    spj = jax.tree_util.tree_map(
        lambda l: jnp.asarray(l)[0],
        J.sample_workloads(14, K=1, M=M, B=B, per_job=True,
                           family=("power", "log")).sp)
    sp = port_speedup(spj)
    assert sp.A.shape == (M,)
    ref = P.smartfill_batched(sp, wl.X, wl.W, B=B)
    _equal(plan_sharded(sp, wl.X, wl.W, B=B, mesh=mesh(2)), ref,
           PLAN_FIELDS)
    pols = (PP.WeightedMarginalRatePolicy(sp, B=B),)
    ref = P.simulate_ensemble(sp, pols, wl.X, wl.W)
    _equal(simulate_ensemble_sharded(sp, pols, wl.X, wl.W, mesh=mesh(2)),
           ref, SIM_FIELDS)


def test_plan_parity_class_aggregates():
    """Class-aggregated fleets shard: ``plan_classes_sharded`` reproduces
    ``plan_classes_batched`` bit for bit — identical orders (the
    host-side compaction and normalized-size ordering are shared code)
    and identical J/θ/T.  Zero-count classes ride along as inert
    padding."""
    wl = J.sample_class_workloads(31, K=K, C=5, B=B)
    counts = wl.counts.copy()
    counts[2] = 0.0
    counts[2, 3] = 4.0           # one nearly-empty instance in the batch
    sp = port_speedup(wl.sp)
    ref_orders, ref = P.plan_classes_batched(counts, wl.sizes, wl.weights,
                                             sp, B=B)
    for D in DS:
        orders, sh = plan_classes_sharded(counts, wl.sizes, wl.weights, sp,
                                          B=B, mesh=mesh(D),
                                          chunk_size=chunk(D, 8))
        np.testing.assert_array_equal(orders, ref_orders)
        _equal(sh, ref, PLAN_FIELDS)
    j_orders, jref = jax_sharded(
        JD.plan_classes_sharded, counts, wl.sizes, wl.weights, wl.sp, B=B,
        mesh=JD.fleet_mesh(), chunk_size=8)
    np.testing.assert_array_equal(ref_orders, np.asarray(j_orders))
    np.testing.assert_allclose(np_(ref.J), np.asarray(jref.J), rtol=1e-6)