"""Port vs JAX: per-job SmartFill (paper §7) and its completion-order search.

The same seeded mixed-family instances (all five Table-1 families, σ = ±1
within one instance) go through the JAX package's ``smartfill_hetero``
and the port's.  The searched orders must agree, and J and J_linear to
rtol 1e-9, as in ``test_torch_smartfill.py``.  ``normalized_order``
sorts by a float64 key and the exchange step takes an argmin: where two
candidates tie within rounding the packages could pick different
orders; such an instance is then held to the reference's own 1e-6
(``tests/core/test_hetero.py``) and named in the test's report, never
dropped.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as P
from repro.core.gwf import cap_residual as cap_residual_j
from repro_torch.core.speedup import map_leaves
from torch_port_util import np_, port_speedup, t64

B = 10.0
EXACT = 1e-9
ORACLE = 1e-6
ALL = ("power", "shifted", "log", "neg_power", "saturating")
N_INSTANCES, CHUNKS = 64, 4


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


def _draw(n, m_hi):
    """n seeded instances, M = 3..m_hi, unsorted sizes; even ones with
    slowdown weights 1/x, odd ones with weights drawn apart from the
    sizes (so the exchange search has work to do)."""
    rng = np.random.default_rng(0)
    out = []
    for i in range(n):
        m = int(rng.integers(3, m_hi + 1))
        st = J.stack_speedups([_rand_member(rng) for _ in range(m)])
        x = rng.uniform(0.5, 20.0, m)
        w = 1.0 / x if i % 2 == 0 else rng.uniform(0.05, 2.0, m)
        out.append((st, x, w))
    return out


@functools.lru_cache(maxsize=1)
def _instances():
    """The 64 instances of the differential sweep, M = 3..5 (the
    reference's own range, ``tests/core/test_hetero.py``)."""
    return _draw(N_INSTANCES, 5)


@pytest.mark.parametrize("chunk", range(CHUNKS))
def test_hetero_matches_jax_on_mixed_instances(chunk):
    per = N_INSTANCES // CHUNKS
    ties = []
    for i in range(chunk * per, (chunk + 1) * per):
        st, x, w = _instances()[i]
        ref = J.smartfill_hetero(st, x, w, B=B)
        out = P.smartfill_hetero(port_speedup(st), t64(x), t64(w), B=B)
        assert isinstance(out.order, np.ndarray) and out.J_linear > 0
        assert out.J >= out.J_linear * (1 - 1e-9), i
        if np.array_equal(out.order, ref.order):
            for key in ("J", "J_linear"):
                assert getattr(out, key) == pytest.approx(
                    getattr(ref, key), rel=EXACT), (i, key)
        else:
            ties.append((i, ref.order.tolist(), out.order.tolist()))
            assert out.J == pytest.approx(ref.J, rel=ORACLE), (
                f"instance {i}: orders {ref.order} (JAX) and {out.order} "
                f"(port) differ and so do J {ref.J} and {out.J}")
    # a tie is reported, never dropped
    if ties:
        print(f"instances whose orders differ within rounding: {ties}")


def test_a_kink_minimum_spreads_the_references_own_j():
    """Where μ* sits on a parking kink, J moves linearly with where the
    descent stops, and the JAX package compiled and run op by op already
    disagree past 1e-9.  The port follows the op-by-op run.

    Instance 42 of the same stream drawn with M up to 6: at the last
    iteration F's minimum is at the kink where a job parks; compiled
    JAX stops the descent at μ = 9.97417, op by op (and the port) at
    9.96770, 7.6e-9 apart in J.  The op-by-op run is of that last
    iteration's minimizer, on the compiled run's own c and a.
    """
    import importlib
    jsf = importlib.import_module("repro.core.smartfill")
    psf = importlib.import_module("repro_torch.core.smartfill")
    st, x, w = _draw(43, 6)[42]
    ref = J.smartfill_hetero(st, x, w, B=B)
    out = P.smartfill_hetero(port_speedup(st), t64(x), t64(w), B=B)
    assert np.array_equal(out.order, ref.order)
    assert abs(out.J - ref.J) > EXACT * ref.J            # the spread
    assert out.J == pytest.approx(ref.J, rel=ORACLE)
    assert out.J == pytest.approx(out.J_linear, rel=EXACT)

    p = ref.order
    spj = jsf._permute_speedup(st, p)
    M = k = len(x) - 1
    M += 1
    W = float(np.cumsum(w[p])[k])
    live = np.arange(M) < k
    c = np.where(live, np.asarray(ref.c), 0.0)
    a = np.where(live, np.asarray(ref.a), 0.0)
    bp = J.hetero_breakpoints_init(M, jnp.float64)
    for kk in range(k):
        bp = J.hetero_breakpoints_insert(spj, jnp.asarray(ref.c), kk, *bp)
    _, _, chain = jsf._make_f(spj, jnp.asarray(c), jnp.asarray(a), k, W,
                              jnp.asarray(B), None, 64, bp=bp)
    with jax.disable_jit():
        mu_eager = float(jsf._minimize_f_hinted(
            *chain, jnp.asarray(B), 32, 40, jnp.zeros(()))[0])
    mu_compiled = float(ref.theta[k, k])

    spt = port_speedup(spj)
    ln = psf._Lanes(spt, 1, M)
    bpt = P.hetero_breakpoints_init(M, torch.float64, "cpu", (1,))
    for kk in range(k):
        bpt = P.hetero_breakpoints_insert(ln.jobs, t64(ref.c)[None], kk,
                                          *bpt)
    Bt = t64([B])
    probes = psf._sorted_probes(ln, t64(c)[None], t64(a)[None], k,
                                t64([W]), Bt, bpt, 64, True)
    mu_port = float(psf._minimize_f_hinted(
        *probes[:3], Bt, 32, 40, torch.zeros(1, dtype=torch.float64))[0])
    assert abs(mu_eager - mu_compiled) > 1e-4
    assert mu_port == pytest.approx(mu_eager, rel=EXACT)
    assert float(out.theta[k, k]) == pytest.approx(mu_port, rel=1e-6)


@pytest.mark.parametrize("seed,m", [(7, 3), (8, 3), (9, 4), (10, 4)])
def test_planner_against_brute_force_oracle(seed, m):
    """The exchange search finds the brute-force order's J (≤ 1e-6)."""
    rng = np.random.default_rng(seed)
    st = port_speedup(J.stack_speedups([_rand_member(rng)
                                        for _ in range(m)]))
    x = rng.uniform(0.5, 20.0, m)
    w = rng.uniform(0.05, 2.0, m)
    dev = P.smartfill_hetero(st, t64(x), t64(w), B=B, exchange_passes=3)
    ref = P.smartfill_hetero_reference(st, t64(x), t64(w), B=B,
                                       search="brute", coarse=256,
                                       zoom_rounds=3)
    assert dev.J <= ref.J * (1 + ORACLE), (dev.J, ref.J)
    assert sorted(ref.order.tolist()) == list(range(m))


def test_hetero_reference_exchange_matches_jax():
    st, x, w = _instances()[1]
    kw = dict(B=B, search="exchange", coarse=128, zoom_rounds=3)
    ref = J.smartfill_hetero_reference(st, x, w, **kw)
    out = P.smartfill_hetero_reference(port_speedup(st), t64(x), t64(w),
                                       **kw)
    assert np.array_equal(out.order, ref.order)
    assert out.J == pytest.approx(ref.J, rel=EXACT)


def test_sequential_exchange_matches_batched():
    """The batched scorer and the sequential search pick the same order
    and the same J (the final order is re-solved unhinted in both)."""
    for i in (1, 3, 5):
        st, x, w = _instances()[i]
        spt = port_speedup(st)
        a = P.smartfill_hetero(spt, t64(x), t64(w), B=B)
        b = P.smartfill_hetero(spt, t64(x), t64(w), B=B,
                               batched_exchange=False)
        assert np.array_equal(a.order, b.order), i
        assert a.J == b.J, i


def test_exchange_window_two_matches_jax():
    st, x, w = _instances()[3]
    ref = J.smartfill_hetero(st, x, w, B=B, exchange_window=2)
    out = P.smartfill_hetero(port_speedup(st), t64(x), t64(w), B=B,
                             exchange_window=2)
    assert np.array_equal(out.order, ref.order)
    assert out.J == pytest.approx(ref.J, rel=EXACT)


@pytest.mark.parametrize("fam", ["shifted", "power", "neg_power"])
def test_homogeneous_broadcast_is_the_shared_path(fam):
    """An (M,) broadcast of one function is planned bit for bit as the
    shared function (``collapse_homogeneous``), fast path included."""
    spj = {"shifted": J.shifted_power(1.0, 4.0, 0.5, B),
           "power": J.power(1.0, 0.5, B),
           "neg_power": J.neg_power(1.0, 1.0, -1.0, B)}[fam]
    sp = port_speedup(spj)
    x = t64(np.arange(6, 0, -1.0))
    w = 1.0 / x
    a = P.smartfill(sp, x, w, B=B)
    for other in (P.broadcast_speedup(sp, 6),
                  P.stack_speedups([sp] * 6)):
        b = P.smartfill(other, x, w, B=B)
        assert a.J == b.J
        assert torch.equal(a.theta, b.theta) and torch.equal(a.c, b.c)
    h = P.smartfill_hetero(P.broadcast_speedup(sp, 6), x, w, B=B)
    assert h.order.tolist() == list(range(6))
    assert torch.equal(h.theta, P.smartfill(sp, x, w, B=B, coarse=24).theta)


def test_homogeneous_broadcast_batched():
    sp = port_speedup(J.log_speedup(1.0, 1.0, B))
    wl = P.sample_workloads(3, K=8, M=5, B=B, device="cpu")
    a = P.smartfill_batched(sp, wl.X, wl.W, B=B)
    b = P.smartfill_batched(P.broadcast_speedup(sp, 5), wl.X, wl.W, B=B)
    assert torch.equal(a.J, b.J) and torch.equal(a.theta, b.theta)


def test_hetero_batched_matches_jax_and_single():
    wl_j = J.sample_workloads(9, K=12, M=5, B=B, family=ALL, per_job=True,
                              m_range=(2, 5))
    wl = P.sample_workloads(9, K=12, M=5, B=B, family=ALL, per_job=True,
                            m_range=(2, 5), device="cpu")
    orders_j, ref = J.smartfill_hetero_batched(wl_j.sp, wl_j.X, wl_j.W, B=B,
                                               active=wl_j.active)
    orders, out = P.smartfill_hetero_batched(wl.sp, wl.X, wl.W, B=B,
                                             active=wl.active)
    assert np.array_equal(orders, np.asarray(orders_j))
    np.testing.assert_allclose(np_(out.J), np.asarray(ref.J), rtol=EXACT)
    np.testing.assert_allclose(np_(out.J_linear), np.asarray(ref.J_linear),
                               rtol=EXACT)
    th = np_(out.theta)
    for k in range(12):
        mk = int(wl.m[k])
        spk = map_leaves(wl.sp, lambda l: l[k, :mk])
        single = P.smartfill_hetero(spk, wl.X[k, :mk], wl.W[k, :mk], B=B,
                                    exchange_passes=0)
        assert np.array_equal(orders[k][:mk], single.order), k
        assert float(out.J[k]) == pytest.approx(single.J, rel=ORACLE), k
        # padded slots stay exact zeros
        assert np.all(th[k, mk:, :] == 0.0) and np.all(th[k, :, mk:] == 0.0)


def test_hetero_cap_satisfies_cdr_conditions():
    rng = np.random.default_rng(1)
    stj = J.stack_speedups([_rand_member(rng) for _ in range(5)])
    st = port_speedup(stj)
    for _ in range(20):
        c = np.sort(rng.uniform(0.05, 1.0, 5))[::-1].copy()
        b = rng.uniform(0.5, 9.5)
        for th in (P.solve_cap(st, b, t64(c)),
                   P.solve_cap_hetero_sorted(st, b, t64(c))):
            res = {k: float(v) for k, v in
                   P.cap_residual(st, b, t64(c), th).items()}
            assert res["budget"] < 1e-8 * max(1.0, b)
            assert res["ratio"] < 1e-9
            assert res["park"] < 1e-9
            ref = cap_residual_j(stj, b, jnp.asarray(c), jnp.asarray(np_(th)))
            for key in ("budget", "ratio", "park"):
                assert res[key] == pytest.approx(float(ref[key]), abs=1e-12)


def test_normalized_order_matches_jax():
    for st, x, w in _instances()[:8]:
        assert np.array_equal(
            P.normalized_order(port_speedup(st), t64(x), t64(w), B),
            J.normalized_order(st, x, w, B))


def test_leaf_count_is_checked():
    st, x, w = _instances()[0]
    with pytest.raises(ValueError, match="entries for"):
        P.smartfill_hetero(port_speedup(st), t64(x[:-1]), t64(w[:-1]), B=B)


# the knobs plan_classes hands smartfill_hetero (tests/core/test_classes.py)
CLASS_KNOBS = dict(coarse=64, descent_iters=96, cap_iters=64,
                   exchange_passes=2, exchange_window=1, stol_rel=1e-10)


def test_class_aggregate_instance_matches_jax():
    """Twelve class aggregates (31,250 jobs each, all five families):
    A·n^{−γ} and w·n make aggregates whose saturating rows have w near
    9e5 against a budget of 10, where the per-job CAP's residual never
    reaches rtol·b.  Before the solver stopped at a stalled Newton step,
    the final CAP of iteration 9 fell back into the segment and its
    column broke the CDR conditions, which carried into c and put J
    5.9e-5 above the JAX package's.  The same order, J and J_linear to
    1e-9; μ* to 1e-7 through iteration 8.  From iteration 9 on F is flat
    at its minimum (4e-10 relative over a 7e-5 move of μ*), and the JAX
    package compiled and run op by op already place μ* 7.3e-5 apart
    there, so those iterations are held by F's minimum, a_k, to 1e-9.
    The final CAP column of every iteration meets the CDR conditions.
    """
    wl = J.sample_class_workloads(2, K=1, C=12, B=B,
                                  count_range=(31250, 31250))
    st = wl.state(0)
    spj = J.class_speedup(st.sp, st.counts)
    X, W = st.counts * st.sizes, st.counts * st.weights
    ref = J.smartfill_hetero(spj, X, W, B=B, **CLASS_KNOBS)
    spt = port_speedup(spj)
    out = P.smartfill_hetero(spt, t64(X), t64(W), B=B, **CLASS_KNOBS)
    assert np.array_equal(out.order, ref.order)
    assert out.J == pytest.approx(ref.J, rel=EXACT)
    assert out.J_linear == pytest.approx(ref.J_linear, rel=EXACT)
    mu, mu_ref = np.diag(np_(out.theta)), np.diag(np.asarray(ref.theta))
    np.testing.assert_allclose(mu[:9], mu_ref[:9], rtol=1e-7)
    np.testing.assert_allclose(np_(out.a), np.asarray(ref.a), rtol=EXACT)
    perm = torch.as_tensor(out.order)
    sp_o = map_leaves(spt, lambda l: l[perm])
    for k in range(1, len(X)):
        res = P.cap_residual(map_leaves(sp_o, lambda l: l[:k]), B - mu[k],
                             out.c[:k], out.theta[:k, k])
        assert float(res["ratio"]) < 1e-9, (k, res)
