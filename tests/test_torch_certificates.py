"""Port vs JAX: plan certificates (``robust/certificates.py``).

``allocation_ok`` is batch-first in the port: (K, M) allocations give
one verdict a workload, held row by row to the JAX package's
single-instance verdict on the same numpy inputs.  ``certify_plan``
reads the same budget, KKT and Prop. 9 numbers as the JAX package's on
the same schedule (the port's SmartFill plan and the reference's agree
to ~1e-16 in J), and the same planted faults fail it on the same field.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro.robust as JR
import repro_torch.core as P
import repro_torch.robust as PR
from repro_torch.core.speedup import map_leaves
from torch_port_util import np_, port_speedup, t64

B = 8.0
X = np.array([5.0, 3.0, 1.0])


@pytest.fixture(scope="module")
def plans():
    spj = J.power(1.0, 0.5, B)
    spt = port_speedup(spj)
    return (spj, J.smartfill(spj, X, 1.0 / X, B=B),
            spt, P.smartfill(spt, X, 1.0 / X, B=B))


def _both(theta, b, active):
    """The port's and the JAX package's verdicts on one allocation."""
    got = PR.allocation_ok(t64(theta), b, t64(active))
    ref = JR.allocation_ok(jnp.asarray(theta), b, jnp.asarray(active))
    assert got.ndim == 0 and got.dtype == torch.bool
    assert bool(got) == bool(ref)
    return bool(got)


def test_allocation_ok_accepts_feasible():
    active = np.array([True, True, False])
    assert _both(np.array([3.0, 5.0, 0.0]), B, active)
    # exactly at budget with slack tolerance
    assert _both(np.array([8.0, 0.0, 0.0]), B, active)


def test_allocation_ok_rejects_each_violation():
    """Each violation alone, and all of them as the rows of one (K, M)
    call: one verdict per row, each the JAX package's, so a failing row
    never fails another."""
    active = np.ones(3, bool)
    rows = [np.array([np.nan, 1.0, 1.0]), np.array([np.inf, 1.0, 1.0]),
            np.array([-1.0, 1.0, 1.0]), np.array([5.0, 5.0, 5.0]),
            np.array([2.0, 3.0, 1.0])]
    want = [False, False, False, False, True]
    for row, ok in zip(rows, want):
        assert _both(row, B, active) is ok
    assert not _both(np.ones(3), np.nan, active)
    batch = PR.allocation_ok(t64(np.stack(rows)), B,
                             t64(np.tile(active, (5, 1))))
    assert batch.shape == (5,) and batch.tolist() == want
    # per-lane budgets: row 3 fits a budget of 16
    Bv = np.array([B, B, B, 16.0, B])
    batch = PR.allocation_ok(t64(np.stack(rows)), t64(Bv),
                             t64(np.tile(active, (5, 1))))
    assert batch.tolist() == [False, False, False, True, True]


def test_allocation_ok_ignores_inactive_slots():
    """Garbage parked on inactive slots must not fail the certificate —
    the engine zeroes them before they are spent."""
    assert _both(np.array([4.0, np.nan, 100.0]), B,
                 np.array([True, False, False]))


def test_certify_real_plan_passes(plans):
    spj, schedj, spt, sched = plans
    cert = PR.certify_plan(spt, sched, B=B)
    ref = JR.certify_plan(spj, schedj, B=B)
    assert cert.ok and ref.ok and cert.finite
    assert isinstance(cert.ok, bool) and isinstance(cert.finite, bool)
    assert cert.budget < 1e-8
    assert max(cert.kkt.values()) < 1e-6
    assert cert.j_gap < 1e-8
    assert cert.budget == pytest.approx(ref.budget, abs=1e-12)
    for k in ("order", "ratio", "park"):
        assert cert.kkt[k] == pytest.approx(ref.kkt[k], abs=1e-9)


def test_certify_detects_corruption(plans):
    spj, schedj, spt, sched = plans
    bad = dataclasses.replace(sched, theta=sched.theta * 1.5)
    badj = dataclasses.replace(schedj, theta=np.asarray(schedj.theta) * 1.5)
    cert, ref = PR.certify_plan(spt, bad, B=B), JR.certify_plan(spj, badj,
                                                               B=B)
    assert not cert.ok and not ref.ok
    assert cert.budget > 0.1                # overspends every phase
    assert cert.budget == pytest.approx(ref.budget, rel=1e-12)

    nan = dataclasses.replace(
        sched, theta=torch.where(sched.theta > 0, torch.nan, 0.0))
    cert = PR.certify_plan(spt, nan, B=B)
    assert not cert.ok and not cert.finite


def test_certify_detects_kkt_violation(plans):
    """A feasible but non-optimal allocation (budget respected, water
    levels wrong) must fail on the KKT residual, not the budget row."""
    spj, schedj, spt, sched = plans
    theta = np_(sched.theta).copy()
    col = theta[:, -1].copy()
    live = np.flatnonzero(col > 1e-9)
    assert live.size >= 2
    shift = 0.4 * col[live[0]]
    col[live[0]] -= shift
    col[live[1]] += shift
    theta[:, -1] = col
    cert = PR.certify_plan(spt, dataclasses.replace(sched, theta=t64(theta)),
                           B=B)
    ref = JR.certify_plan(spj, dataclasses.replace(schedj, theta=theta), B=B)
    assert cert.budget < 1e-8               # still on budget
    assert not cert.ok and not ref.ok
    assert max(cert.kkt.values()) > 1e-3
    for k in ("order", "ratio", "park"):
        assert cert.kkt[k] == pytest.approx(ref.kkt[k], rel=1e-6, abs=1e-12)


def test_certify_per_job_plan_in_rank_coordinates():
    """A per-job (§7) plan certifies with ``sp`` permuted into its
    ranks, as the JAX package's does; ``check_j_gap=False`` skips the
    Prop. 9 identity."""
    wl = J.sample_workloads(3, K=1, M=5, B=B, per_job=True,
                            family=("power", "log", "saturating"))
    spj = jax.tree_util.tree_map(lambda l: jnp.asarray(l)[0], wl.sp)
    spt = port_speedup(spj)
    x, w = wl.X[0], wl.W[0]
    plan = P.smartfill_hetero(spt, x, w, B=B)
    planj = J.smartfill_hetero(spj, x, w, B=B)
    assert np.array_equal(plan.order, planj.order)
    o = plan.order
    cert = PR.certify_plan(map_leaves(spt, lambda l: l[o]), plan,
                           B=B, check_j_gap=False)
    ref = JR.certify_plan(jax.tree_util.tree_map(lambda l: l[o], spj),
                          planj, B=B, check_j_gap=False)
    assert cert.ok == ref.ok
    assert np.isnan(cert.j_gap)
    assert cert.budget < 1e-8 and max(cert.kkt.values()) < 1e-6
