"""Port vs JAX: the seeded workload sampler, bit for bit.

``sample_workloads`` draws everything with numpy from one seed, so the
port's copy must give the JAX package's arrays exactly: sizes, weights,
arrival times, live counts and every speedup leaf.
"""
import numpy as np
import pytest
import torch

import repro.core as J
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
