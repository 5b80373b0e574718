"""The port's planning slice end to end, and the rules it lives by.

The quickstart instance (8 jobs, s(θ) = ln(1+θ), B = 10) goes through the
JAX package and the port: Θ, J, J_linear, the CDR check, the power fit
and heSRPT's simulated J must agree.  Then: neither ``repro_torch`` nor
``chip_smoke.py`` imports JAX or the JAX package, and an entry point
with no device on a machine without a GPU raises instead of running on
the CPU.
"""
import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.hesrpt as J_hesrpt
import repro_torch.core as P
import repro_torch.core.hesrpt as P_hesrpt
from torch_port_util import np_, port_speedup, t64

ROOT = Path(__file__).resolve().parents[1]
B = 10.0
M = 8
X = np.arange(M, 0, -1.0) * 2.0
W = 1.0 / X


@pytest.fixture(scope="module")
def quickstart():
    spj = J.log_speedup(1.0, 1.0, B)
    spt = port_speedup(spj)
    return (spj, J.smartfill(spj, X, W, B=B),
            spt, P.smartfill(spt, t64(X), t64(W), B=B))


def test_quickstart_schedule(quickstart):
    _, ref, _, out = quickstart
    assert out.J == pytest.approx(ref.J, rel=1e-9)
    assert out.J_linear == pytest.approx(ref.J_linear, rel=1e-9)
    assert out.J == pytest.approx(out.J_linear, rel=1e-9)       # Prop. 9
    # Θ at the JAX package's own batched-vs-single tolerance (μ* sits at
    # a flat minimum; see test_torch_smartfill.py)
    np.testing.assert_allclose(np_(out.theta), np_(ref.theta), atol=1e-6 * B)
    parked_t = np_(out.theta) == 0.0
    parked_j = np_(ref.theta) == 0.0
    assert np.array_equal(parked_t, parked_j) and parked_j.any()


def test_quickstart_cdr(quickstart):
    spj, ref, spt, out = quickstart
    vt = P.cdr_violation(spt, out.theta)
    vj = J.cdr_violation(spj, ref.theta)
    for key in ("ratio", "park"):
        assert vt[key] <= 1e-9 and vj[key] <= 1e-9
    np.testing.assert_allclose(P.estimate_constants(spt, out.theta),
                               J.estimate_constants(spj, ref.theta),
                               rtol=1e-6)


def test_quickstart_hesrpt(quickstart):
    spj, ref, spt, out = quickstart
    fit_t = P.fit_power(lambda t: np.log1p(t), B)
    fit_j = J.fit_power(lambda t: np.log1p(t), B)
    assert fit_t == pytest.approx(fit_j, rel=1e-12)
    p_fit = fit_t[1]
    res_t = P.simulate_policy(spt, X, W, P.hesrpt_policy(p_fit, B))
    res_j = J.simulate_policy(spj, X, W, J.hesrpt_policy(p_fit, B))
    assert res_t.J == pytest.approx(res_j.J, rel=1e-12)
    np.testing.assert_allclose(res_t.T, res_j.T, rtol=1e-12)
    assert out.J < res_t.J                      # SmartFill beats heSRPT
    np.testing.assert_allclose(P.hesrpt_allocations(W[:5], p_fit, B),
                               J.hesrpt_allocations(W[:5], p_fit, B),
                               rtol=1e-15)
    ol_t = P_hesrpt.hesrpt_open_loop(spt, X, W, p_fit, fit_t[0], B)
    ol_j = J_hesrpt.hesrpt_open_loop(spj, X, W, p_fit, fit_j[0], B)
    assert ol_t[1] == pytest.approx(ol_j[1], rel=1e-12)


def test_smartfill_schedule_replays_in_simulator(quickstart):
    """The schedule's T, executed by the host simulator, is its own."""
    _, _, spt, out = quickstart
    th = np_(out.theta)

    def policy(rem, w, active):
        k = int(active.sum())
        alloc = np.zeros_like(rem)
        alloc[np.flatnonzero(active)] = th[:k, k - 1]
        return alloc

    res = P.simulate_policy_reference(spt, X, W, policy, B=B)
    np.testing.assert_allclose(res.T, np_(out.T), rtol=1e-9)


def test_batched_spot_check_matches_single():
    """examples/batched_planning.py part 1, cut to 32 instances."""
    rng = np.random.default_rng(0)
    N, Mb = 32, 16
    Xb = np.zeros((N, Mb))
    Wb = np.zeros((N, Mb))
    ms = rng.integers(2, Mb + 1, N)
    for n in range(N):
        xs = np.sort(rng.uniform(0.5, 20.0, ms[n]))[::-1]
        Xb[n, :ms[n]] = xs
        Wb[n, :ms[n]] = 1.0 / xs
    sp = P.log_speedup(1.0, 1.0, B, device="cpu")
    sched = P.smartfill_batched(sp, Xb, Wb, B=B)
    n0 = int(np.argmax(ms))
    one = P.smartfill(sp, Xb[n0, :ms[n0]], Wb[n0, :ms[n0]], B=B)
    assert abs(float(sched.J[n0]) - one.J) / one.J <= 1e-9
    ref = J.smartfill_batched(J.log_speedup(1.0, 1.0, B), Xb, Wb, B=B)
    np.testing.assert_allclose(np_(sched.J), np_(ref.J), rtol=1e-9)


_PROBE = """
import sys
sys.path[:0] = [{src!r}, {root!r}]
import repro_torch, repro_torch.core, repro_torch.convert
import repro_torch.sched.policies
import repro_torch.kernels.gwf_waterfill.ops
import repro_torch.kernels.flash_attention.ops
import repro_torch.kernels.linear_scan.ops
import repro_torch.models.transformer, repro_torch.serve.engine
import repro_torch.launch.serve
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))
print(bad)
"""


def test_port_imports_neither_jax_nor_repro():
    code = _PROBE.format(src=str(ROOT / "src"), root=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_ast_scan_finds_no_jax_or_repro_import():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 10
    for f in files:
        for mod in _imports(f):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), f"{f}: {mod}"


def test_entry_points_without_device_need_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        P.log_speedup(1.0, 1.0, B)
    gen = P.GenericSpeedup(s_fn=torch.log1p, ds_fn=lambda t: 1 / (1 + t),
                           B=B)
    with pytest.raises(RuntimeError, match="no GPU"):
        P.smartfill(gen, X, W, B=B)
    with pytest.raises(RuntimeError, match="no GPU"):
        P.solve_cap_batched(gen, 1.0, np.ones((2, 3)))
    with pytest.raises(RuntimeError, match="no GPU"):
        P.smartfill_batched(gen, X[None], W[None], B=B)
    # asked for the CPU, or handed CPU tensors, it runs there
    sp = P.log_speedup(1.0, 1.0, B, device="cpu")
    assert sp.A.device.type == "cpu"
    assert P.smartfill(gen, X[:3], W[:3], B=B, device="cpu",
                       coarse=4, descent_iters=2).theta.device.type == "cpu"
