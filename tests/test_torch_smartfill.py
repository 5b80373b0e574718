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
    members = [FAMILIES["log"], FAMILIES["shifted"], FAMILIES["power"]]
    st = P.stack_speedups([port_speedup(m) for m in members])
    x = t64([3.0, 2.0, 1.0])
    with pytest.raises(NotImplementedError, match="next slice"):
        P.smartfill(st, x, 1.0 / x)
    with pytest.raises(NotImplementedError):
        P.smartfill_batched(port_speedup(FAMILIES["log"]), x[None],
                            (1.0 / x)[None], stol_rel=1e-6)


@pytest.mark.parametrize("k", [1, 3, 5])
def test_f_grid_matches_jax(k):
    """F(μ) over a grid at iteration k, from one JAX SmartFill's c, a."""
    from repro.core.smartfill import _f_grid as f_grid_j
    from repro_torch.core.smartfill import _f_grid as f_grid_t
    spj = FAMILIES["shifted"]
    x = SIZES[:6]
    w = 1.0 / x
    ref = J.smartfill(spj, x, w, B=B)
    c = np.where(np.arange(6) < k, np.asarray(ref.c), 0.0)
    a = np.where(np.arange(6) < k, np.asarray(ref.a), 0.0)
    mus = np.linspace(0.05, B, 9)
    W_k = float(np.cumsum(w)[k])
    fj = np.asarray(f_grid_j(spj, jnp.asarray(mus), jnp.asarray(c),
                             jnp.asarray(a), k, W_k, B))
    ft = np_(f_grid_t(port_speedup(spj), t64(mus)[None], t64(c)[None],
                      t64(a)[None], k, t64([W_k]), t64([B])))[0]
    np.testing.assert_allclose(ft, fj, rtol=1e-12)
