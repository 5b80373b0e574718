"""Port vs JAX: speedup families, s / s' / s'⁻¹ / s'(0) in float64.

Every port speedup is built through ``repro_torch.convert`` from the JAX
object's leaves.  Tolerance: rtol 1e-12 (the same elementwise formulas
in float64); ``GenericSpeedup.ds_inv`` (an 80-step bisection) to
1e-10·B.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.speedup as J
import repro_torch.core.speedup as P
from torch_port_util import np_, port_speedup, t64

B = 10.0
TABLE1 = {
    "power": J.power(1.0, 0.5, B),
    "power_steep": J.power(2.0, 0.2, B),
    "shifted": J.shifted_power(1.0, 4.0, 0.5, B),
    "log": J.log_speedup(1.0, 1.0, B),
    "log_scaled": J.log_speedup(2.0, 0.5, B),
    "neg_power": J.neg_power(1.0, 1.0, -1.0, B),
    "saturating": J.saturating(1.0, 12.0, 2.0, B),
    "roofline": J.from_roofline(4096.0, 6e12, 2e9, B, peak_flops=989e12,
                                link_bw=450e9),
}
CTORS = {
    "power": (P.power, (1.0, 0.5, B)),
    "shifted": (P.shifted_power, (1.0, 4.0, 0.5, B)),
    "log": (P.log_speedup, (1.0, 1.0, B)),
    "neg_power": (P.neg_power, (1.0, 1.0, -1.0, B)),
    "saturating": (P.saturating, (1.0, 12.0, 2.0, B)),
}


def _theta(seed=0, n=64):
    rng = np.random.default_rng(seed)
    return np.concatenate([[0.0, B], rng.uniform(0.0, B, n)])


def _mixed_jax():
    members = [TABLE1[k] for k in ("power", "shifted", "log", "neg_power",
                                   "saturating")] * 2
    return J.stack_speedups(members)


def _generic_pair():
    spj = J.GenericSpeedup(s_fn=lambda t: jnp.sqrt(4.0 + t) - 2.0,
                           ds_fn=lambda t: 0.5 / jnp.sqrt(4.0 + t), B=B)
    spt = port_speedup(spj, s_fn=lambda t: torch.sqrt(4.0 + t) - 2.0,
                       ds_fn=lambda t: 0.5 / torch.sqrt(4.0 + t))
    return spj, spt


@pytest.mark.parametrize("name", list(TABLE1))
def test_table1_s_ds_ds0(name):
    spj = TABLE1[name]
    spt = port_speedup(spj)
    th = _theta()
    np.testing.assert_allclose(np_(spt.s(t64(th))), np_(spj.s(th)),
                               rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(np_(spt.ds(t64(th[1:]))), np_(spj.ds(th[1:])),
                               rtol=1e-12)
    assert np_(spt.ds0()) == pytest.approx(float(spj.ds0()), rel=1e-12)


@pytest.mark.parametrize("name", list(TABLE1))
def test_table1_ds_inv(name):
    spj = TABLE1[name]
    spt = port_speedup(spj)
    y = np.asarray(spj.ds(_theta(1)[2:]))
    np.testing.assert_allclose(np_(spt.ds_inv(t64(y))), np_(spj.ds_inv(y)),
                               rtol=1e-12, atol=1e-12 * B)


@pytest.mark.parametrize("name", list(CTORS))
def test_constructors_match_jax_leaves(name):
    fn, args = CTORS[name]
    spt = fn(*args, device="cpu")
    spj = getattr(J, fn.__name__)(*args)
    for leaf in ("A", "w", "gamma"):
        assert float(getattr(spt, leaf)) == float(getattr(spj, leaf))
        assert getattr(spt, leaf).dtype == torch.float64
    assert spt.sigma == spj.sigma and spt.B == spj.B


def test_stacked_mix():
    spj = _mixed_jax()
    spt = port_speedup(spj)
    assert isinstance(spt, P.StackedSpeedup)
    rng = np.random.default_rng(2)
    th = rng.uniform(0.0, B, spj.A.shape[0])
    np.testing.assert_allclose(np_(spt.s(t64(th))), np_(spj.s(th)),
                               rtol=1e-12)
    np.testing.assert_allclose(np_(spt.ds(t64(th))), np_(spj.ds(th)),
                               rtol=1e-12)
    y = np.asarray(spj.ds(th))
    np.testing.assert_allclose(np_(spt.ds_inv(t64(y))), np_(spj.ds_inv(y)),
                               rtol=1e-12, atol=1e-12 * B)
    np.testing.assert_allclose(np_(spt.ds0()), np_(spj.ds0()), rtol=1e-12)


def test_stack_speedups_builds_the_same_mix():
    members = [TABLE1[k] for k in ("power", "log", "saturating")]
    stj = J.stack_speedups(members)
    stt = P.stack_speedups([port_speedup(m) for m in members])
    for leaf in ("A", "w", "gamma", "sigma"):
        np.testing.assert_array_equal(np_(getattr(stt, leaf)),
                                      np_(getattr(stj, leaf)))
    with pytest.raises(TypeError):
        P.stack_speedups([_generic_pair()[1]])


def test_generic_speedup():
    spj, spt = _generic_pair()
    th = _theta(3)
    np.testing.assert_allclose(np_(spt.s(t64(th))), np_(spj.s(th)),
                               rtol=1e-12, atol=1e-300)
    np.testing.assert_allclose(np_(spt.ds(t64(th))), np_(spj.ds(th)),
                               rtol=1e-12)
    assert float(spt.ds0()) == pytest.approx(float(spj.ds0()), rel=1e-12)
    # inside and outside s'([0, B]): the clamps at 0 and B included
    y = np.concatenate([np.asarray(spj.ds(th)), [0.3, 0.01]])
    np.testing.assert_allclose(np_(spt.ds_inv(t64(y))), np_(spj.ds_inv(y)),
                               rtol=0, atol=1e-10 * B)


def test_per_job_helpers():
    spj = _mixed_jax()
    spt = port_speedup(spj)
    M = spj.A.shape[0]
    assert P.is_per_job(spt) and J.is_per_job(spj)
    assert not P.is_per_job(port_speedup(TABLE1["log"]))
    assert P.inner_per_job(spt, None)
    for i in (0, 3, M - 1):
        one_t, one_j = P.take_job(spt, i), J.take_job(spj, i)
        assert float(one_t.ds(torch.tensor(1.5, dtype=torch.float64))) == \
            pytest.approx(float(one_j.ds(1.5)), rel=1e-12)
    th = np.random.default_rng(4).uniform(0.0, B, (M, M))
    np.testing.assert_allclose(np_(P.rowwise(spt).s(t64(th))),
                               np_(J.rowwise(spj).s(th)), rtol=1e-12)
    # per-instance (N,) leaves are not per-job inside a batched solve
    per_inst = P.map_leaves(port_speedup(TABLE1["log"]),
                            lambda l: l.expand(5))
    assert P.is_per_job(per_inst) and not P.inner_per_job(per_inst, 5)


@pytest.mark.parametrize("name", ["log", "saturating", "power"])
def test_broadcast_and_collapse_homogeneous(name):
    spt = port_speedup(TABLE1[name])
    wide = P.broadcast_speedup(spt, 6)
    assert P.is_per_job(wide)
    back = P.collapse_homogeneous(wide)
    assert isinstance(back, P.RegularSpeedup) and not P.is_per_job(back)
    assert back.sigma == spt.sigma
    # a constant StackedSpeedup collapses all the way to a RegularSpeedup
    st = P.stack_speedups([spt] * 4)
    col = P.collapse_homogeneous(st)
    colj = J.collapse_homogeneous(J.stack_speedups([TABLE1[name]] * 4))
    assert type(col).__name__ == type(colj).__name__ == "RegularSpeedup"
    assert col.sigma == colj.sigma
    np.testing.assert_allclose(float(col.A), float(colj.A), rtol=1e-15)


def test_validation_errors():
    with pytest.raises(ValueError):
        P.RegularSpeedup(A=t64(1.0), w=t64(1.0), gamma=t64(-0.5), sigma=2,
                         B=B)
    with pytest.raises(ValueError):      # log family needs w > 0
        P.RegularSpeedup(A=t64(1.0), w=t64(0.0), gamma=t64(-1.0), sigma=1,
                         B=B)
    with pytest.raises(ValueError):
        P.StackedSpeedup(A=t64([1.0]), w=t64([1.0]), gamma=t64([-0.5]),
                         sigma=t64([0.5]), B=B)
    with pytest.raises(ValueError):
        P.power(1.0, 1.5, B, device="cpu")


@pytest.mark.parametrize("overlap", [0.0, 0.5, 1.0 - 1e-12])
def test_from_roofline_matches_jax(overlap):
    args = (4096.0, 6e12, 2e9, B)
    kw = dict(peak_flops=197e12, link_bw=50e9, overlap=overlap)
    spj = J.from_roofline(*args, **kw)
    spt = P.from_roofline(*args, **kw, device="cpu")
    for leaf in ("A", "w", "gamma"):
        assert float(getattr(spt, leaf)) == pytest.approx(
            float(getattr(spj, leaf)), rel=1e-14)
    # the port's defaults are one H100 (989 TFLOP/s bf16, 450 GB/s NVLink)
    h100 = P.from_roofline(*args, device="cpu")
    ref = J.from_roofline(*args, peak_flops=989e12, link_bw=450e9)
    assert float(h100.w) == pytest.approx(float(ref.w), rel=1e-14)


def test_check_concave():
    for name in ("log", "shifted", "saturating"):
        assert port_speedup(TABLE1[name]).check_concave()
    assert _generic_pair()[1].check_concave()
