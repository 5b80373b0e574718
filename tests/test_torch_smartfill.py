"""Port vs JAX: SmartFill, single-instance and batched, in float64.

J, J_linear and the value coefficients a agree to rtol 1e-9 on every
path, and every output agrees to rtol 1e-9 on the closed-form μ* path
(pure power).  On the descent paths μ* sits at a flat minimum of F: F
moves by O(δ²) for a step δ in μ, so two float64 implementations that
round F differently settle μ* apart by up to ~sqrt(eps)·μ and the
schedule (Θ, c, durations, T) moves with it while J does not.  Those
outputs are held to the tolerance the JAX package holds its own batched
planner to its single-instance one: Θ to 1e-6·B, T and durations to
rtol 1e-6 (``tests/core/test_batch.py:18,51-54,111-114``).
``test_schedule_spread_is_the_references_own`` shows the cause: JAX
against itself with a longer descent moves the schedule past 1e-9 while
J stays at float64 rounding, and the port's spread is of the same size.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
import repro_torch.core as P
from torch_port_util import np_, port_speedup, t64

B = 10.0
FAMILIES = {
    "power": J.power(1.0, 0.5, B),
    "shifted": J.shifted_power(1.0, 4.0, 0.5, B),
    "log": J.log_speedup(1.0, 1.0, B),
    "neg_power": J.neg_power(1.0, 1.0, -1.0, B),
    "saturating": J.saturating(1.0, 12.0, 2.0, B),
}
EXACT = 1e-9
SCHED = 1e-6


def _generic_pair():
    spj = J.GenericSpeedup(s_fn=lambda t: jnp.sqrt(4.0 + t) - 2.0,
                           ds_fn=lambda t: 0.5 / jnp.sqrt(4.0 + t), B=B)
    spt = port_speedup(spj, s_fn=lambda t: torch.sqrt(4.0 + t) - 2.0,
                       ds_fn=lambda t: 0.5 / torch.sqrt(4.0 + t))
    return spj, spt


def _padded(seed, N, M):
    rng = np.random.default_rng(seed)
    X = np.zeros((N, M))
    W = np.zeros((N, M))
    ms = rng.integers(2, M + 1, N)
    for n in range(N):
        xs = np.sort(rng.uniform(0.5, 20.0, ms[n]))[::-1]
        X[n, :ms[n]] = xs
        W[n, :ms[n]] = 1.0 / xs
    return X, W, ms


def _check(out, ref, exact, batched=False):
    """Compare every SmartFill output of the port with JAX's."""
    sched = EXACT if exact else SCHED
    for key in ("J", "J_linear"):
        np.testing.assert_allclose(np.asarray(np_(getattr(out, key))),
                                   np.asarray(np_(getattr(ref, key))),
                                   rtol=EXACT)
    np.testing.assert_allclose(np_(out.a), np_(ref.a), rtol=EXACT,
                               atol=1e-300)
    np.testing.assert_allclose(np_(out.theta), np_(ref.theta),
                               rtol=sched, atol=sched * (B if not exact
                                                         else 0.0))
    for key in ("c", "durations", "T"):
        np.testing.assert_allclose(np_(getattr(out, key)),
                                   np_(getattr(ref, key)), rtol=sched,
                                   atol=1e-300 if exact else 1e-12)
    if batched:
        assert torch.equal(out.m, torch.tensor(np.array(ref.m)))


SIZES = np.arange(9, 0, -1.0) * 1.7


@pytest.mark.parametrize("fam", ["shifted", "log", "neg_power", "saturating"])
def test_schedule_spread_is_the_references_own(fam):
    spj = FAMILIES[fam]
    x = SIZES
    w = 1.0 / x
    ref = J.smartfill(spj, x, w, B=B)
    alt = J.smartfill(spj, x, w, B=B, descent_iters=60)   # default 40
    out = P.smartfill(port_speedup(spj), t64(x), t64(w), B=B)

    def spread(a, b):
        return float(np.abs(np_(a) - np_(b)).max())

    assert abs(alt.J - ref.J) <= 1e-14 * ref.J
    assert spread(alt.theta, ref.theta) > EXACT * B
    assert spread(alt.T, ref.T) > EXACT * float(np_(ref.T).min())
    assert spread(out.theta, ref.theta) <= 4 * spread(alt.theta, ref.theta)
    assert spread(out.T, ref.T) <= 4 * spread(alt.T, ref.T)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_smartfill_single(fam):
    spj = FAMILIES[fam]
    spt = port_speedup(spj)
    x = SIZES
    w = 1.0 / x
    ref = J.smartfill(spj, x, w, B=B)
    out = P.smartfill(spt, t64(x), t64(w), B=B)
    assert isinstance(out.J, float)
    _check(out, ref, exact=(fam == "power"))
    assert out.J == pytest.approx(out.J_linear, rel=1e-9)   # Prop. 9


def test_smartfill_power_descent_path():
    """fast_path=False forces the descent minimizer on pure power."""
    spj = FAMILIES["power"]
    x = SIZES[:6]
    w = np.linspace(0.5, 2.0, 6)
    ref = J.smartfill(spj, x, w, B=B, fast_path=False)
    out = P.smartfill(port_speedup(spj), t64(x), t64(w), B=B,
                      fast_path=False)
    _check(out, ref, exact=False)


def test_smartfill_generic_speedup():
    spj, spt = _generic_pair()
    x = np.array([7.0, 4.0, 2.5, 1.0])
    w = 1.0 / x
    kw = dict(coarse=8, descent_iters=12)      # keep the bisections few
    ref = J.smartfill(spj, x, w, B=B, **kw)
    out = P.smartfill(spt, t64(x), t64(w), B=B, **kw)
    _check(out, ref, exact=False)


@pytest.mark.parametrize("fam", ["power", "shifted", "log", "saturating"])
def test_smartfill_batched_padded(fam):
    spj = FAMILIES[fam]
    spt = port_speedup(spj)
    X, W, ms = _padded(1, N=8, M=12)
    ref = J.smartfill_batched(spj, X, W, B=B, validate=True)
    out = P.smartfill_batched(spt, t64(X), t64(W), B=B, validate=True)
    _check(out, ref, exact=(fam == "power"), batched=True)
    for n in range(X.shape[0]):
        m = ms[n]
        assert np.all(np_(out.theta[n, m:, :]) == 0.0)
        assert np.all(np_(out.c[n, m:]) == 0.0)
    one = out.instance(3)
    assert one.J == pytest.approx(float(ref.J[3]), rel=EXACT)


def test_smartfill_batched_per_instance_budgets_and_leaves():
    rng = np.random.default_rng(2)
    N = 5
    spj = J.RegularSpeedup(A=jnp.asarray(rng.uniform(0.3, 1.0, N)),
                           w=jnp.asarray(rng.uniform(1.0, 6.0, N)),
                           gamma=jnp.asarray(rng.uniform(-0.8, -0.2, N)),
                           sigma=1, B=B)
    X, W, _ = _padded(3, N=N, M=7)
    Bv = rng.uniform(4.0, 12.0, N)
    ref = J.smartfill_batched(spj, X, W, B=Bv)
    out = P.smartfill_batched(port_speedup(spj), t64(X), t64(W), B=t64(Bv))
    _check(out, ref, exact=False, batched=True)


def test_allocations_single_and_batched():
    spj = FAMILIES["log"]
    spt = port_speedup(spj)
    X, W, ms = _padded(4, N=6, M=9)
    ref = J.smartfill_allocations_batched(spj, X, W, B=B)
    out = P.smartfill_allocations_batched(spt, t64(X), t64(W), B=B)
    np.testing.assert_allclose(np_(out), np_(ref), atol=SCHED * B)
    np.testing.assert_allclose(np_(out).sum(1), B, rtol=1e-9)
    n = int(np.argmax(ms))
    one = P.smartfill_allocations(spt, t64(X[n, :ms[n]]), t64(W[n, :ms[n]]),
                                  B=B)
    one_j = J.smartfill_allocations(spj, X[n, :ms[n]], W[n, :ms[n]], B=B)
    np.testing.assert_allclose(np_(one), np_(one_j), atol=SCHED * B)
    np.testing.assert_allclose(np_(out[n, :ms[n]]), np_(one), atol=SCHED * B)


def test_completion_times_and_objective():
    spj = FAMILIES["shifted"]
    spt = port_speedup(spj)
    x = SIZES[:5]
    w = 1.0 / x
    sched = J.smartfill(spj, x, w, B=B)
    th = np.asarray(sched.theta)
    dj, Tj = J.completion_times(spj, x, th)
    dt, Tt = P.completion_times(spt, t64(x), t64(th))
    np.testing.assert_allclose(np_(dt), np_(dj), rtol=1e-12)
    np.testing.assert_allclose(np_(Tt), np_(Tj), rtol=1e-12)
    assert float(P.objective(t64(w), Tt)) == pytest.approx(
        float(J.objective(w, Tj)), rel=1e-12)


def test_validate_errors():
    spt = port_speedup(FAMILIES["log"])
    with pytest.raises(ValueError, match="non-increasing"):
        P.smartfill(spt, t64([1.0, 3.0]), t64([1.0, 1.0]))
    with pytest.raises(ValueError, match="non-decreasing"):
        P.smartfill(spt, t64([3.0, 1.0]), t64([2.0, 1.0]))
    X = np.array([[3.0, 1.0, 0.0], [1.0, 2.0, 0.0]])
    W = np.ones_like(X)
    with pytest.raises(ValueError, match="instance 1"):
        P.smartfill_batched(spt, t64(X), t64(W), validate=True)
    act = np.array([[True, False, True], [True, True, False]])
    with pytest.raises(ValueError, match="prefix mask"):
        P.smartfill_batched(spt, t64(X), t64(W), active=t64(act))


def test_per_job_and_deferred_knobs_raise():
    """Per-job speedups and ``stol_rel`` are planned now (against JAX);
    what still raises is a malformed warm payload or leaf count."""
    members = [FAMILIES["log"], FAMILIES["shifted"], FAMILIES["power"]]
    stj = J.stack_speedups(members)
    st = P.stack_speedups([port_speedup(m) for m in members])
    x = np.array([3.0, 2.0, 1.0])
    ref = J.smartfill(stj, x, 1.0 / x, B=B, validate=False)
    out = P.smartfill(st, t64(x), t64(1.0 / x), B=B, validate=False)
    assert out.J == pytest.approx(ref.J, rel=EXACT)
    ref = J.smartfill_batched(FAMILIES["log"], x[None], (1.0 / x)[None],
                              stol_rel=1e-6)
    out = P.smartfill_batched(port_speedup(FAMILIES["log"]), t64(x)[None],
                              t64(1.0 / x)[None], stol_rel=1e-6)
    assert float(out.J[0]) == pytest.approx(float(ref.J[0]), rel=EXACT)
    with pytest.raises(ValueError, match="padded"):
        P.smartfill_warm(st, t64(x), t64(1.0 / x), warm=P.WarmStart(
            lam=torch.ones(5, dtype=torch.float64),
            bracket=t64([1e-6, 1.0])))
    with pytest.raises(ValueError, match="entries for"):
        P.smartfill_hetero(st, t64(x[:2]), t64(1.0 / x[:2]))


def _mixed_instance(seed, m):
    """A σ = ±1 mixed per-job instance in the completion order the
    port's planner finds (J == J_linear there: a realized order)."""
    wl = J.sample_workloads(seed, K=1, M=m, B=B, family=J.FAMILIES,
                            per_job=True)
    spj = jax.tree_util.tree_map(lambda l: jnp.asarray(l)[0], wl.sp)
    x, w = wl.X[0], wl.W[0]
    p = P.smartfill_hetero(port_speedup(spj), t64(x), t64(w), B=B).order
    spj = jax.tree_util.tree_map(lambda l: l[p], spj)
    return spj, port_speedup(spj), x[p], w[p]


@pytest.mark.parametrize("kind", ["per_job", "generic", "log"])
def test_smartfill_warm_lam_and_bracket_match_jax(kind):
    """The payload of a cold call, and a warm call seeded with it, against
    JAX: J to 1e-9; λ* per iteration and the carried λ-bracket are set by
    μ*, so to the schedule's tolerance."""
    if kind == "per_job":
        spj, spt, x, w = _mixed_instance(30, 6)
    else:
        if kind == "generic":
            spj, spt = _generic_pair()
        else:
            spj = FAMILIES["log"]
            spt = port_speedup(spj)
        x = np.array([7.0, 4.0, 2.5, 1.0])
        w = 1.0 / x
    kw = dict(coarse=8, descent_iters=12) if kind == "generic" else {}
    ref, ws_j = J.smartfill_warm(spj, x, w, B=B, **kw)
    out, ws_t = P.smartfill_warm(spt, t64(x), t64(w), B=B, **kw)
    assert out.J == pytest.approx(out.J_linear, rel=EXACT)
    assert out.J == pytest.approx(ref.J, rel=EXACT)
    np.testing.assert_allclose(np_(ws_t.lam), np.asarray(ws_j.lam),
                               rtol=SCHED)
    np.testing.assert_allclose(np_(ws_t.bracket), np.asarray(ws_j.bracket),
                               rtol=SCHED)
    assert ws_t.lam.shape == (len(x),) and ws_t.bracket.shape == (2,)
    if kind == "per_job":
        assert bool((ws_t.lam[1:] > 0).all()) and float(ws_t.lam[0]) == 0.0
    x2 = x * 0.97
    ref2, _ = J.smartfill_warm(spj, x2, w, B=B, warm=ws_j, **kw)
    out2, _ = P.smartfill_warm(spt, t64(x2), t64(w), B=B, warm=ws_t, **kw)
    assert out2.J == pytest.approx(ref2.J, rel=EXACT)


@pytest.mark.parametrize("seed", [31, 32])
def test_smartfill_warm_against_cold(seed):
    """Seeded from the previous plan of a related instance (every job
    3% further on), the warm plan is the cold one (1e-9 rel J)."""
    _, spt, x, w = _mixed_instance(seed, 7)
    _, ws = P.smartfill_warm(spt, t64(x), t64(w), B=B)
    x2 = t64(x * 0.97)
    cold = P.smartfill(spt, x2, t64(w), B=B, validate=False)
    assert cold.J == pytest.approx(cold.J_linear, rel=EXACT)
    warm, ws2 = P.smartfill_warm(spt, x2, t64(w), B=B, warm=ws)
    assert warm.J == pytest.approx(cold.J, rel=EXACT)
    assert warm.J == pytest.approx(warm.J_linear, rel=EXACT)
    assert bool(torch.isfinite(ws2.bracket).all())


def test_stale_warm_payload_gives_the_cold_plan():
    """A payload from another budget (×1/20) or another job order is
    rejected where it does not bracket λ*: the plan is the cold one."""
    _, spt, x, w = _mixed_instance(33, 6)
    _, ws = P.smartfill_warm(spt, t64(x), t64(w), B=B)
    cold = P.smartfill(spt, t64(x), t64(w), B=B / 20, validate=False)
    warm, _ = P.smartfill_warm(spt, t64(x), t64(w), B=B / 20, warm=ws)
    assert warm.J == pytest.approx(cold.J, rel=EXACT)
    shuffled = P.WarmStart(lam=ws.lam[torch.tensor([0, 3, 5, 1, 4, 2])],
                           bracket=ws.bracket.flip(0))
    cold = P.smartfill(spt, t64(x), t64(w), B=B, validate=False)
    warm, _ = P.smartfill_warm(spt, t64(x), t64(w), B=B, warm=shuffled)
    assert warm.J == pytest.approx(cold.J, rel=EXACT)
    # the generic path's bracket, collapsed onto one wrong point
    spj, gen = _generic_pair()
    xs = t64([7.0, 4.0, 2.5, 1.0])
    kw = dict(coarse=8, descent_iters=12)
    cold = P.smartfill(gen, xs, 1.0 / xs, B=B, **kw)
    bad = P.WarmStart(lam=torch.zeros(4, dtype=torch.float64),
                      bracket=t64([1e3, 1e3 * (1 + 1e-12)]))
    warm, _ = P.smartfill_warm(gen, xs, 1.0 / xs, B=B, warm=bad, **kw)
    assert warm.J == pytest.approx(cold.J, rel=EXACT)


@pytest.mark.parametrize("kind", ["log", "per_job"])
def test_smartfill_reference_matches_jax(kind):
    """The host-loop oracle (512-point grid, four zoom rounds)."""
    if kind == "per_job":
        spj, spt, x, w = _mixed_instance(34, 4)
    else:
        spj = FAMILIES["log"]
        spt = port_speedup(spj)
        x = SIZES[:5]
        w = 1.0 / x
    ref = J.smartfill_reference(spj, x, w, B=B, validate=False)
    out = P.smartfill_reference(spt, t64(x), t64(w), B=B, validate=False)
    for key in ("J", "J_linear"):
        assert getattr(out, key) == pytest.approx(getattr(ref, key),
                                                  rel=EXACT)
    np.testing.assert_allclose(np_(out.a), np.asarray(ref.a), rtol=EXACT)
    np.testing.assert_allclose(np_(out.theta), np.asarray(ref.theta),
                               atol=SCHED * B)
    fast = P.smartfill(spt, t64(x), t64(w), B=B, validate=False)
    assert fast.J == pytest.approx(out.J, rel=SCHED)


@pytest.mark.parametrize("stol_rel", [None, 1e-10])
def test_smartfill_batched_per_job_and_stol_rel(stol_rel):
    """Per-job (N, M) leaves, rows in the order ``hetero_order_batch``
    gives them, with the descent's exit tolerance overridden, against
    JAX.

    J_linear and a to 1e-9 on every row, and J where the order is
    realized (J == J_linear).  Where it is not, J is the executed cost of
    clamped durations, which moves linearly with where the descent
    stops: there the JAX package compiled and run op by op disagree past
    1e-9, and the port is held to the op-by-op run at 1e-9 and to the
    compiled one at the schedule's tolerance.
    """
    import importlib
    from repro.core.batch import hetero_order_batch
    jsf = importlib.import_module("repro.core.smartfill")
    wl = J.sample_workloads(35, K=6, M=6, B=B, family=J.FAMILIES,
                            per_job=True, m_range=(2, 6))
    _, sp, X, W = hetero_order_batch(wl.sp, jnp.asarray(wl.X),
                                     jnp.asarray(wl.W), wl.m, B)
    X, W = np.asarray(X), np.asarray(W)
    ref = J.smartfill_batched(sp, X, W, B=B, stol_rel=stol_rel)
    out = P.smartfill_batched(port_speedup(sp), t64(X), t64(W), B=B,
                              stol_rel=stol_rel)
    np.testing.assert_allclose(np_(out.J_linear), np.asarray(ref.J_linear),
                               rtol=EXACT)
    np.testing.assert_allclose(np_(out.a), np.asarray(ref.a), rtol=EXACT,
                               atol=1e-300)
    np.testing.assert_allclose(np_(out.theta), np.asarray(ref.theta),
                               atol=SCHED * B)
    realized = np.abs(np_(out.J) - np_(out.J_linear)) <= EXACT * np_(out.J)
    assert realized.sum() >= 4
    for n in range(6):
        Jn, Jr = float(out.J[n]), float(ref.J[n])
        if realized[n]:
            assert Jn == pytest.approx(Jr, rel=EXACT), n
            continue
        assert Jn == pytest.approx(Jr, rel=SCHED), n
        m = int(wl.m[n])          # the live prefix: padding adds zeros
        spn = jax.tree_util.tree_map(lambda l: l[n, :m], sp)
        with jax.disable_jit():
            eager = jsf._solve(spn, jnp.asarray(X[n, :m]),
                               jnp.asarray(W[n, :m]), B, m, 32, 40, 64,
                               False, stol_rel=stol_rel)
        assert Jn == pytest.approx(float(eager[5]), rel=EXACT), n


@pytest.mark.parametrize("precise,with_times", [(False, True),
                                                (True, False)])
def test_solve_knobs_match_jax(precise, with_times):
    """``precise=False`` (a cold six-step solve a grid point, two-step
    descent probes, the large-instance exit) and ``with_times=False``
    (no durations, T or J) on a per-job instance, against JAX's _solve."""
    import importlib
    jsf = importlib.import_module("repro.core.smartfill")
    psf = importlib.import_module("repro_torch.core.smartfill")
    spj, spt, x, w = _mixed_instance(36, 6)
    ref = jsf._solve(spj, jnp.asarray(x), jnp.asarray(w), B, 6, 32, 40, 64,
                     False, precise=precise, with_times=with_times)
    out = psf._solve(spt, t64(x)[None], t64(w)[None], t64([B]),
                     torch.tensor([6]), 32, 40, 64, False, precise=precise,
                     with_times=with_times)
    np.testing.assert_allclose(np_(out[6])[0], float(ref[6]), rtol=EXACT)
    np.testing.assert_allclose(np_(out[2])[0], np.asarray(ref[2]),
                               rtol=EXACT)
    np.testing.assert_allclose(np_(out[0])[0], np.asarray(ref[0]),
                               atol=SCHED * B)
    if with_times:
        np.testing.assert_allclose(np_(out[5])[0], float(ref[5]),
                                   rtol=EXACT)
    else:
        assert float(out[5][0]) == 0.0 and not bool(out[4].any())


def test_large_instance_prices_the_grid_with_hetero_approx():
    """M ≥ 33 takes ``hetero_approx`` for the μ-grid, a 3-point window
    and the relaxed exit; per-job batched plan against JAX."""
    from repro.core.batch import hetero_order_batch
    wl = J.sample_workloads(37, K=2, M=34, B=B, family=J.FAMILIES,
                            per_job=True, m_range=(30, 34))
    _, sp, X, W = hetero_order_batch(wl.sp, jnp.asarray(wl.X),
                                     jnp.asarray(wl.W), wl.m, B)
    X, W = np.asarray(X), np.asarray(W)
    ref = J.smartfill_batched(sp, X, W, B=B)
    out = P.smartfill_batched(port_speedup(sp), t64(X), t64(W), B=B)
    np.testing.assert_allclose(np_(out.J_linear), np.asarray(ref.J_linear),
                               rtol=EXACT)
    np.testing.assert_allclose(np_(out.a), np.asarray(ref.a), rtol=EXACT,
                               atol=1e-300)
    np.testing.assert_allclose(np_(out.theta), np.asarray(ref.theta),
                               atol=SCHED * B)
