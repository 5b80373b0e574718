"""Port vs JAX: the CAP solvers of ``core/gwf.py`` in float64.

Tolerance 1e-10·max(1, b): the reference's own in
``tests/core/test_gwf_solvers.py`` and ``tests/core/test_hetero_fast.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.gwf as J
import repro_torch.core.gwf as P
from repro.core import (GenericSpeedup, log_speedup, neg_power, power,
                        sample_workloads, saturating, shifted_power)
from torch_port_util import np_, port_speedup, t64

B = 10.0
SPS = {
    "power": power(1.0, 0.5, B),
    "shifted": shifted_power(1.0, 4.0, 0.5, B),
    "log": log_speedup(1.0, 1.0, B),
    "neg_power": neg_power(1.0, 1.0, -1.0, B),
    "saturating": saturating(1.0, 12.0, 2.0, B),
}
BUDGETS = (0.3, 4.0, 9.5)
ALL = ("power", "shifted", "log", "neg_power", "saturating")


def tol(b):
    return 1e-10 * max(1.0, float(np.max(b)))


def _c(seed, k, m=None):
    rng = np.random.default_rng(seed)
    c = np.sort(rng.uniform(0.02, 1.0, k))[::-1].copy()
    c[0] = 1.0
    active = np.arange(k) < (k if m is None else m)
    return c, active


def _batch(seed, N, k):
    rng = np.random.default_rng(seed)
    C = np.zeros((N, k))
    for n in range(N):
        kk = int(rng.integers(2, k + 1))
        C[n, :kk] = np.sort(rng.uniform(0.05, 1.0, kk))[::-1]
    return C, C > 0, rng.uniform(0.5, 9.0, N)


def _per_job(seed, N, k):
    wl = sample_workloads(seed, K=N, M=k, B=B, family=ALL, per_job=True,
                          m_range=(2, k))
    rng = np.random.default_rng(seed + 1)
    C = np.zeros((N, k))
    for n in range(N):
        m = int(wl.m[n])
        C[n, :m] = np.sort(rng.uniform(0.05, 1.0, m))[::-1]
    return wl.sp, C, C > 0, rng.uniform(1.0, 9.0, N)


def _generic_pair():
    spj = GenericSpeedup(s_fn=lambda t: jnp.sqrt(4.0 + t) - 2.0,
                         ds_fn=lambda t: 0.5 / jnp.sqrt(4.0 + t), B=B)
    spt = port_speedup(spj, s_fn=lambda t: torch.sqrt(4.0 + t) - 2.0,
                       ds_fn=lambda t: 0.5 / torch.sqrt(4.0 + t))
    return spj, spt


def test_waterfill_prepare_and_solve():
    rng = np.random.default_rng(0)
    u = rng.uniform(0.1, 5.0, 40)
    h0 = rng.uniform(-2.0, 3.0, 40)
    active = rng.random(40) > 0.3
    u = np.where(active, u, 0.0)
    prep_j = J.waterfill_prepare(jnp.asarray(u), jnp.asarray(h0),
                                 jnp.asarray(active))
    prep_t = P.waterfill_prepare(t64(u), t64(h0), t64(active))
    for a, b in zip(prep_t, prep_j):
        np.testing.assert_allclose(np_(a), np_(b), rtol=1e-12, atol=1e-12)
    for b in BUDGETS + (40.0,):
        th_j = J.waterfill_solve(prep_j, jnp.asarray(u), jnp.asarray(h0), b,
                                 jnp.asarray(active))
        th_t = P.waterfill_solve(prep_t, t64(u), t64(h0), b, t64(active))
        np.testing.assert_allclose(np_(th_t), np_(th_j), atol=tol(b))
        assert float(P.waterfill_level(t64(u), t64(h0), b)) == pytest.approx(
            float(J.waterfill_level(jnp.asarray(u), jnp.asarray(h0), b)),
            rel=1e-12)


@pytest.mark.parametrize("fam", list(SPS))
@pytest.mark.parametrize("solver", ["solve_cap_regular",
                                    "solve_cap_regular_reference"])
def test_solve_cap_regular(fam, solver):
    spj = SPS[fam]
    spt = port_speedup(spj)
    c, active = _c(1, 24, m=19)
    for b in BUDGETS:
        ref = getattr(J, solver)(spj, b, jnp.asarray(c), jnp.asarray(active))
        out = getattr(P, solver)(spt, b, t64(c), t64(active))
        np.testing.assert_allclose(np_(out), np_(ref), atol=tol(b))
        assert abs(float(out.sum()) - b) < tol(b)


@pytest.mark.parametrize("fam", ["shifted", "log", "saturating"])
def test_solve_cap_generic_with_brackets(fam):
    spj = SPS[fam]
    spt = port_speedup(spj)
    c, active = _c(2, 16)
    for b in BUDGETS:
        cold_j, br_j = J.solve_cap_generic(spj, b, jnp.asarray(c),
                                           jnp.asarray(active),
                                           return_bracket=True)
        cold_t, br_t = P.solve_cap_generic(spt, b, t64(c), t64(active),
                                           return_bracket=True)
        np.testing.assert_allclose(np_(cold_t), np_(cold_j), atol=tol(b))
        # a good (just-solved) bracket and a stale one, with the adaptive exit
        good = (np_(br_j[0]) * 0.9, np_(br_j[1]) * 1.1)
        stale = (np_(br_j[1]) * 50.0, np_(br_j[1]) * 100.0)
        for br in (good, stale):
            ref = J.solve_cap_generic(spj, b, jnp.asarray(c),
                                      jnp.asarray(active), bracket=br,
                                      rel_tol=1e-13)
            out = P.solve_cap_generic(spt, b, t64(c), t64(active),
                                      bracket=(t64(br[0]), t64(br[1])),
                                      rel_tol=1e-13)
            np.testing.assert_allclose(np_(out), np_(ref), atol=tol(b))
        ok_j = J.cap_bracket_probe(spj, b, jnp.asarray(c), stale,
                                   jnp.asarray(active))
        ok_t = P.cap_bracket_probe(spt, b, t64(c),
                                   (t64(stale[0]), t64(stale[1])),
                                   t64(active))
        assert [bool(x) for x in ok_t] == [bool(x) for x in ok_j]


def test_solve_cap_generic_speedup():
    spj, spt = _generic_pair()
    c, active = _c(3, 12)
    for b in BUDGETS:
        ref = J.solve_cap(spj, b, jnp.asarray(c), jnp.asarray(active))
        out = P.solve_cap(spt, b, t64(c), t64(active))
        np.testing.assert_allclose(np_(out), np_(ref), atol=tol(b))


@pytest.mark.parametrize("seed", [5, 6])
def test_hetero_sorted_and_solve(seed):
    sp, C, A, bs = _per_job(seed, N=3, k=14)
    for n in range(3):
        spj = jax.tree_util.tree_map(lambda l: jnp.asarray(l)[n], sp)
        spt = port_speedup(spj)
        c, act = C[n], A[n]
        ref = J.solve_cap_hetero_sorted(spj, bs[n], jnp.asarray(c),
                                        jnp.asarray(act))
        out = P.solve_cap_hetero_sorted(spt, bs[n], t64(c), t64(act))
        np.testing.assert_allclose(np_(out), np_(ref), atol=tol(bs[n]))
        prep_j = J.hetero_prepare(spj, jnp.asarray(c), jnp.asarray(act))
        prep_t = P.hetero_prepare(spt, t64(c), t64(act))
        np.testing.assert_allclose(np_(prep_t.pos), np_(prep_j.pos),
                                   rtol=1e-12)
        th_j, lam_j = J.hetero_solve(prep_j, bs[n] / 2, return_lam=True)
        th_t, lam_t = P.hetero_solve(prep_t, bs[n] / 2, return_lam=True)
        np.testing.assert_allclose(np_(th_t), np_(th_j), atol=tol(bs[n]))
        assert float(lam_t) == pytest.approx(float(lam_j), rel=1e-9)
        # the bisection oracle agrees too
        bis = P.solve_cap_hetero(spt, bs[n], t64(c), t64(act))
        np.testing.assert_allclose(np_(bis), np_(ref), atol=1e-9 * bs[n])


@pytest.mark.parametrize("impl", ["closed", "bisect", "auto"])
@pytest.mark.parametrize("fam", ["shifted", "log", "saturating"])
def test_solve_cap_batched_shared(impl, fam):
    spj = SPS[fam]
    spt = port_speedup(spj)
    C, A, bs = _batch(7, N=5, k=12)
    ref = J.solve_cap_batched(spj, bs, jnp.asarray(C), jnp.asarray(A),
                              impl=impl)
    out = P.solve_cap_batched(spt, t64(bs), t64(C), t64(A), impl=impl)
    np.testing.assert_allclose(np_(out), np_(ref), atol=tol(bs))


def test_solve_cap_batched_per_instance_leaves():
    rng = np.random.default_rng(8)
    N = 4
    spj = shifted_power(1.0, 4.0, 0.5, B)
    spj = type(spj)(A=jnp.asarray(rng.uniform(0.3, 1.0, N)),
                    w=jnp.asarray(rng.uniform(1.0, 6.0, N)),
                    gamma=jnp.asarray(rng.uniform(-0.8, -0.2, N)),
                    sigma=1, B=B)
    spt = port_speedup(spj)
    C, A, bs = _batch(9, N=N, k=10)
    for impl in ("closed", "bisect"):
        ref = J.solve_cap_batched(spj, bs, jnp.asarray(C), jnp.asarray(A),
                                  impl=impl)
        out = P.solve_cap_batched(spt, t64(bs), t64(C), t64(A), impl=impl)
        np.testing.assert_allclose(np_(out), np_(ref), atol=tol(bs))


@pytest.mark.parametrize("impl", ["sorted", "bisect", "auto"])
def test_solve_cap_batched_per_job(impl):
    sp, C, A, bs = _per_job(10, N=4, k=12)
    spt = port_speedup(sp)
    ref = J.solve_cap_batched(sp, bs, jnp.asarray(C), jnp.asarray(A),
                              impl=impl)
    out = P.solve_cap_batched(spt, t64(bs), t64(C), t64(A), impl=impl)
    np.testing.assert_allclose(np_(out), np_(ref), atol=tol(bs))


def test_auto_on_cpu_picks_what_jax_picks_off_tpu():
    C, A, bs = _batch(11, N=3, k=9)
    spt = port_speedup(SPS["log"])
    auto = P.solve_cap_batched(spt, t64(bs), t64(C), t64(A))
    closed = P.solve_cap_batched(spt, t64(bs), t64(C), t64(A), impl="closed")
    assert torch.equal(auto, closed)
    sp, C, A, bs = _per_job(12, N=3, k=9)
    spt = port_speedup(sp)
    auto = P.solve_cap_batched(spt, t64(bs), t64(C), t64(A))
    srt = P.solve_cap_batched(spt, t64(bs), t64(C), t64(A), impl="sorted")
    assert torch.equal(auto, srt)
    _, gen = _generic_pair()
    C, A, bs = _batch(13, N=2, k=6)
    auto = P.solve_cap_batched(gen, t64(bs), t64(C), t64(A))
    bis = P.solve_cap_batched(gen, t64(bs), t64(C), t64(A), impl="bisect")
    assert torch.equal(auto, bis)


def test_n_equals_k_is_ambiguous():
    N = k = 6
    spt = port_speedup(SPS["log"])
    spt = P.map_leaves(spt, lambda l: l.expand(N).clone())
    C, A, bs = _batch(14, N=N, k=k)
    for impl in ("auto", "closed", "sorted", "bisect", "cuda"):
        with pytest.raises(ValueError, match="K == M"):
            P.solve_cap_batched(spt, t64(bs), t64(C), t64(A), impl=impl)


def test_cap_residual_matches():
    spj = SPS["log"]
    spt = port_speedup(spj)
    c, active = _c(15, 10)
    th = np_(P.solve_cap_regular(spt, 3.0, t64(c), t64(active)))
    rj = J.cap_residual(spj, 3.0, jnp.asarray(c), jnp.asarray(th),
                        jnp.asarray(active))
    rt = P.cap_residual(spt, 3.0, t64(c), t64(th), t64(active))
    for key in ("budget", "order", "ratio", "park"):
        assert float(rt[key]) == pytest.approx(float(rj[key]), abs=1e-12)
        assert float(rt[key]) < 1e-8


def test_batch_axes_and_instance_view():
    from repro.core.batch import batch_axes as batch_axes_j
    from repro_torch.core.batch import batch_axes
    N = 4
    spj = shifted_power(1.0, 4.0, 0.5, B)
    spj = type(spj)(A=jnp.ones(N), w=spj.w, gamma=jnp.full(N, -0.5),
                    sigma=1, B=B)
    spt = port_speedup(spj)
    axes_j = batch_axes_j(spj, N)
    assert batch_axes(spt, N) == {"A": axes_j.A, "w": axes_j.w,
                                  "gamma": axes_j.gamma}
    view = P.per_instance(spt, N)
    assert view.A.shape == (N, 1) and view.w.shape == ()


def _mixed(seed, m):
    """A σ = ±1 mixed-family StackedSpeedup of m jobs, in both packages."""
    wl = sample_workloads(seed, K=1, M=m, B=B, family=ALL, per_job=True)
    spj = jax.tree_util.tree_map(lambda l: jnp.asarray(l)[0], wl.sp)
    return spj, port_speedup(spj)


@pytest.mark.parametrize("seed", [20, 21])
def test_breakpoint_store_is_the_one_shot_prepare(seed):
    """The store built one job at a time gives hetero_prepare's curve,
    and the JAX package's store."""
    m = 9
    spj, spt = _mixed(seed, m)
    rng = np.random.default_rng(seed)
    c = np.sort(rng.uniform(0.05, 1.0, m))[::-1].copy()
    c[0] = 1.0
    bp_t = P.hetero_breakpoints_init(m, torch.float64, "cpu")
    bp_j = J.hetero_breakpoints_init(m, jnp.float64)
    for k in range(m):
        bp_t = P.hetero_breakpoints_insert(spt, t64(c), k, *bp_t)
        bp_j = J.hetero_breakpoints_insert(spj, jnp.asarray(c), k, *bp_j)
        act = np.arange(m) <= k
        one = P.hetero_prepare(spt, t64(c), t64(act))
        inc = P.hetero_prepare(spt, t64(c), t64(act), breakpoints=bp_t)
        # curve values are sums of O(B) terms: a value that cancels to
        # ~0 keeps rounding of that size
        for field in ("pos", "vals"):
            np.testing.assert_allclose(np_(getattr(inc, field)),
                                       np_(getattr(one, field)), rtol=1e-12,
                                       atol=1e-12 * B)
        for a, b in zip(bp_t, bp_j):
            np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-12,
                                       atol=1e-12 * B)
    # a masked insert leaves the store as it was
    lam, val = P.hetero_breakpoints_insert(spt, t64(c), 2, *bp_t, live=False)
    assert torch.equal(lam, bp_t[0]) and torch.equal(val, bp_t[1])


def test_breakpoint_store_batched():
    """Batch-first: an (N, M) store with per-instance live masks."""
    sp, C, A, bs = _per_job(22, N=4, k=8)
    spt = P.per_instance(port_speedup(sp), 4)
    Ct = t64(C)
    live = t64(np.array([True, False, True, True]))
    bp = P.hetero_breakpoints_init(8, torch.float64, "cpu", (4,))
    for k in range(8):
        bp = P.hetero_breakpoints_insert(spt, Ct, k, *bp, live=live)
    for n in range(4):
        spn = jax.tree_util.tree_map(lambda l: jnp.asarray(l)[n], sp)
        bj = J.hetero_breakpoints_init(8, jnp.float64)
        if n != 1:
            for k in range(8):
                bj = J.hetero_breakpoints_insert(spn, jnp.asarray(C[n]), k,
                                                 *bj)
        for a, b in zip(bp, bj):
            np.testing.assert_allclose(np_(a[n]), np.asarray(b), rtol=1e-12,
                                       atol=1e-12 * B)


@pytest.mark.parametrize("unroll", [1, 2, 4, 6])
def test_hetero_solve_unrolled_matches_jax(unroll):
    spj, spt = _mixed(23, 10)
    rng = np.random.default_rng(24)
    c = np.sort(rng.uniform(0.05, 1.0, 10))[::-1].copy()
    act = np.arange(10) < 8
    prep_j = J.hetero_prepare(spj, jnp.asarray(c), jnp.asarray(act))
    prep_t = P.hetero_prepare(spt, t64(c), t64(act))
    for b in (0.0, 0.05, 1.3, 6.0, 9.9):
        _, lam_cold = J.hetero_solve(prep_j, b, return_lam=True)
        for hint in (None, 0.0, float(lam_cold) * 1.01, 1e9):
            th_j, lam_j = J.hetero_solve(prep_j, b, lam_hint=hint,
                                         return_lam=True, unroll=unroll)
            th_t, lam_t = P.hetero_solve(prep_t, b, lam_hint=hint,
                                         return_lam=True, unroll=unroll)
            np.testing.assert_allclose(np_(th_t), np.asarray(th_j),
                                       atol=tol(b))
            assert float(lam_t) == pytest.approx(float(lam_j), rel=1e-9)


def test_hetero_approx_matches_jax():
    spj, spt = _mixed(25, 12)
    rng = np.random.default_rng(26)
    c = np.sort(rng.uniform(0.05, 1.0, 12))[::-1].copy()
    act = np.arange(12) < 11
    prep_j = J.hetero_prepare(spj, jnp.asarray(c), jnp.asarray(act))
    prep_t = P.hetero_prepare(spt, t64(c), t64(act))
    grid = np.concatenate([[0.0], np.geomspace(1e-6, B, 15)])
    ref = np.asarray(J.hetero_approx(prep_j, jnp.asarray(grid)))
    out = np_(P.hetero_approx(prep_t, t64(grid)))
    np.testing.assert_allclose(out, ref, atol=tol(B))
    np.testing.assert_allclose(out.sum(-1), grid, rtol=1e-12)
    for b in (0.4, 7.0):
        np.testing.assert_allclose(np_(P.hetero_approx(prep_t, b)),
                                   np.asarray(J.hetero_approx(prep_j, b)),
                                   atol=tol(b))
    # batch-first: one grid per instance
    two = P.hetero_prepare(P.per_instance(
        P.map_leaves(spt, lambda l: l.expand(2, 12)), 2),
        t64(np.stack([c, c])), t64(np.stack([act, act])))
    np.testing.assert_allclose(
        np_(P.hetero_approx(two, t64(np.stack([grid, grid])))[1]), ref,
        atol=tol(B))


def _rand_member(rng):
    f = rng.integers(0, 5)
    a = rng.uniform(0.5, 2.0)
    p = rng.uniform(0.3, 0.9)
    z = rng.uniform(0.5, 6.0)
    if f == 0:
        return power(a, p, B)
    if f == 1:
        return shifted_power(a, z, p, B)
    if f == 2:
        return log_speedup(a, rng.uniform(0.3, 2.0), B)
    if f == 3:
        return neg_power(a, z, -rng.uniform(0.5, 2.0), B)
    return saturating(a, rng.uniform(1.2 * B, 3.0 * B),
                      rng.uniform(1.2, 2.5), B)


def test_sorted_cap_matches_bisection():
    """The sorted solver against the port's λ-bisection, ≤ 1e-10·B, on
    the reference's 16 seeded σ = ±1 mixed instances with masked jobs
    (``tests/core/test_hetero_fast.py:82-124``)."""
    from repro.core import stack_speedups
    rng = np.random.default_rng(0)
    worst = 0.0
    for _ in range(16):
        m = int(rng.integers(3, 9))
        st = port_speedup(stack_speedups([_rand_member(rng)
                                          for _ in range(m)]))
        c = rng.uniform(0.05, 1.0, m)
        active = rng.uniform(size=m) < 0.8
        if not active.any():
            active[0] = True
        b = float(rng.uniform(0.2, 1.0) * B)
        th = P.solve_cap_hetero_sorted(st, b, t64(c), t64(active))
        th0 = P.solve_cap_hetero(st, b, t64(c), t64(active), iters=96)
        worst = max(worst, float((th - th0).abs().max()))
        assert float(torch.where(t64(active), 0.0, th).abs().max()) == 0.0
        assert abs(float(th.sum()) - b) < 1e-9 * B
    assert worst < 1e-10 * B, worst


def test_prepare_once_prices_many_budgets():
    from repro.core import stack_speedups
    rng = np.random.default_rng(1)
    st = port_speedup(stack_speedups([_rand_member(rng) for _ in range(7)]))
    c = t64(rng.uniform(0.05, 1.0, 7))
    active = t64(np.ones(7, bool))
    prep = P.hetero_prepare(st, c, active)
    for b in np.linspace(0.05 * B, B, 40):
        th = P.hetero_solve(prep, float(b))
        th0 = P.solve_cap_hetero(st, float(b), c, active, iters=96)
        assert float((th - th0).abs().max()) < 1e-10 * B


class _Cuda:
    """Stands in for a CUDA tensor where only the device and dtype are
    read (this machine has no card)."""

    is_cuda = True
    device = torch.device("cuda")

    def __init__(self, dtype):
        self.dtype = dtype


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64,
                                   torch.bfloat16])
def test_auto_impl_rule(device, dtype):
    """impl="auto": only a float32 CUDA input of a regular family goes to
    the float32 kernels; every other input takes the reference's solver
    in its own dtype."""
    from repro_torch.kernels.gwf_waterfill import ops
    kernel = device == "cuda" and dtype == torch.float32
    want = {"regular": "closed", "per_job": "sorted", "stacked": "bisect",
            "other": "bisect"}
    for family, plain in want.items():
        got = P.auto_impl(device, dtype, family)
        assert got == ("cuda" if kernel and family != "other" else plain)
    x = _Cuda(dtype) if device == "cuda" else torch.zeros(3, dtype=dtype)
    for family in ("regular", "per_job"):
        assert ops._launches(x, "auto", family) == kernel
        assert ops._launches(x, "cuda", family) == (device == "cuda")
        assert not ops._launches(x, "ref", family)
    with pytest.raises(ValueError, match="unknown impl"):
        ops._launches(x, "pallas", "regular")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_auto_keeps_the_input_dtype_on_the_cpu(dtype):
    C, A, bs = _batch(27, N=3, k=9)
    spt = port_speedup(SPS["shifted"])
    out = P.solve_cap_batched(spt, t64(bs).to(dtype), t64(C).to(dtype),
                              t64(A))
    assert out.dtype == dtype
    sp, C, A, bs = _per_job(28, N=3, k=9)
    out = P.solve_cap_batched(port_speedup(sp), t64(bs).to(dtype),
                              t64(C).to(dtype), t64(A))
    assert out.dtype == dtype


def test_hetero_solve_stops_at_a_stalled_newton_step():
    """The final CAP of iteration 9 of ``test_class_aggregate_instance_
    matches_jax`` (test_torch_hetero.py): nine class aggregates, two of
    them on, a saturating one (w ≈ 8.9e5, σ = −1) and a pure power, at
    b ≈ 3.2.  θ = w − (λc/A)^{1/γ} is a small difference of large terms,
    so β̃'s rounding (~1e-10) stays above rtol·b and the residual exit
    never fires.  From the hint λ*, Newton proposes t itself, a bracket
    end; before that counted as convergence, the fallback threw t back
    into the segment and four unrolled steps ended with θ 0.37 off."""
    spt = P.StackedSpeedup(
        A=t64([93301203691919.38, 49.05185673668851, 69.52644221947408,
               34681.67489104077, 659823070871.4393, 39839.60284960922,
               57448.75515468638, 0.004267808403972414, 54.662009313295066,
               1.0]),
        w=t64([119404.07327948163, 85611.53036368244, 182976.0385430852,
               16503.974061047298, 46769.820133450856, 19832.78002101618,
               16107.458031963142, 886668.5681724861, 0.0, 1.0]),
        gamma=t64([-2.985291976430154, -0.38630289764574166,
                   -0.40116636704965125, -1.0, -2.5550605055058826, -1.0,
                   -1.0, 0.6139108987827788, -0.4261416274710663, -0.5]),
        sigma=t64([1.0] * 7 + [-1.0, 1.0, 1.0]), B=B)
    c = t64([1.0, 9.368749216126702, 8.270325087896163, 32.263881274943955,
             11.839965139726974, 30.809193585817187, 54.667976610835055,
             293.14114967732746, 701.7692986741222, 1.0])
    act = torch.arange(10) < 9
    b = 3.210184868385727
    prep = P.hetero_prepare(spt, c, act)
    th_a, lam_a = P.hetero_solve(prep, b, iters=200, return_lam=True)
    assert np.count_nonzero(np_(th_a)) == 2
    for hint in (0.06524137591188639, float(lam_a)):
        for unroll in (2, 4, 6):
            th = P.hetero_solve(prep, b, lam_hint=hint, unroll=unroll)
            np.testing.assert_allclose(np_(th), np_(th_a), atol=1e-9 * b)
            res = P.cap_residual(spt, b, c, th, active=act)
            assert float(res["ratio"]) < 1e-9, (hint, unroll, res)
