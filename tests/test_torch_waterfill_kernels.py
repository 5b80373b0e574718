"""Port vs JAX: the plain versions of the three CUDA waterfill kernels.

Each plain version (``repro_torch.kernels.gwf_waterfill.ref``) is held
against the JAX Pallas kernel run in interpret mode, as
``tests/kernels/`` runs it on the CPU, on the same float32 inputs and at
the JAX kernel tests' tolerances.  The CUDA kernels themselves are held
against these plain versions on the card by ``chip_smoke.py``.
"""
import ctypes
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sample_workloads
from repro.core import log_speedup, saturating, shifted_power
from repro.kernels.gwf_waterfill import kernel as JK
from repro_torch.kernels import _build
from repro_torch.kernels.gwf_waterfill import kernel as PK
from repro_torch.kernels.gwf_waterfill import ops as PO
from repro_torch.kernels.gwf_waterfill import ref as PR
from torch_port_util import np_

B = 10.0
FAMILIES = {
    "shifted": shifted_power(1.0, 4.0, 0.5, B),
    "log": log_speedup(1.0, 1.0, B),
    "saturating": saturating(1.0, 12.0, 2.0, B),
}
ALL = ("power", "shifted", "log", "neg_power", "saturating")


def f32(x):
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def _instances(seed, N, K, k_lo=2):
    rng = np.random.default_rng(seed)
    C = np.zeros((N, K), np.float32)
    for n in range(N):
        k = rng.integers(k_lo, K + 1)
        C[n, :k] = np.sort(rng.uniform(0.05, 1.0, k))[::-1]
    return C, rng.uniform(0.5, 9.0, N).astype(np.float32)


def _mixed(seed, N, K, m_range=None):
    wl = sample_workloads(seed, K=N, M=K, B=B, family=ALL, per_job=True,
                          m_range=m_range)
    rng = np.random.default_rng(seed + 1)
    C = np.zeros((N, K))
    for n in range(N):
        k = int(wl.m[n])
        C[n, :k] = np.sort(rng.uniform(0.05, 1.0, k))[::-1]
    sp = wl.sp
    arrs = [np.asarray(a, np.float32) for a in
            (C, sp.A, sp.w, sp.gamma, sp.sigma)]
    return arrs, rng.uniform(1.0, 9.0, N).astype(np.float32), wl.m


@pytest.mark.parametrize("fam", list(FAMILIES))
@pytest.mark.parametrize("shape", [(4, 23), (3, 300)])
def test_generic_plain_matches_pallas_interpret(fam, shape):
    sp = FAMILIES[fam]
    C, bs = _instances(1, *shape)
    ker = np.asarray(JK.generic_waterfill(
        jnp.asarray(C), sp.A, sp.w, sp.gamma, jnp.asarray(bs),
        sigma=sp.sigma, iters=64, interpret=True))
    par = [torch.full((shape[0],), float(v), dtype=torch.float32)
           for v in (sp.A, sp.w, sp.gamma)]
    out = np_(PR.generic_waterfill_ref(f32(C), *par, f32(bs),
                                       sigma=sp.sigma, iters=64))
    assert out.dtype == np.float32
    for n in range(shape[0]):
        np.testing.assert_allclose(out[n], ker[n],
                                   atol=2e-4 * max(1.0, bs[n]))
        assert np.all(out[n][C[n] == 0.0] == 0.0)


def test_generic_plain_large_padded_instance():
    """K = 1500 spans two of the TPU kernel's 1024-slot tiles."""
    sp = FAMILIES["shifted"]
    rng = np.random.default_rng(2)
    c = np.zeros((1, 1500), np.float32)
    c[0, :1200] = np.sort(rng.uniform(0.05, 1.0, 1200))[::-1]
    ker = np.asarray(JK.generic_waterfill(
        jnp.asarray(c), sp.A, sp.w, sp.gamma, jnp.asarray([7.0]),
        sigma=sp.sigma, iters=64, interpret=True))[0]
    par = [torch.full((1,), float(v), dtype=torch.float32)
           for v in (sp.A, sp.w, sp.gamma)]
    out = np_(PR.generic_waterfill_ref(f32(c), *par, f32([7.0]),
                                       sigma=1))[0]
    np.testing.assert_allclose(out, ker, atol=2e-3)
    assert abs(out.sum() - 7.0) < 1e-3 * 7.0


@pytest.mark.parametrize("case", ["single_tile", "multi_tile"])
def test_hetero_plain_matches_pallas_interpret(case):
    if case == "single_tile":
        arrs, bs, m = _mixed(12, N=4, K=40, m_range=(5, 40))
        atol = 5e-4
    else:
        arrs, bs, m = _mixed(13, N=2, K=1500)
        atol = 5e-3
    ker = np.asarray(JK.hetero_waterfill(*map(jnp.asarray, arrs),
                                         jnp.asarray(bs), interpret=True))
    out = np_(PR.hetero_waterfill_ref(*map(f32, arrs), f32(bs)))
    np.testing.assert_allclose(out, ker, atol=atol)
    np.testing.assert_allclose(out.sum(axis=1), bs, rtol=1e-5)
    for n in range(len(bs)):
        assert np.all(out[n, int(m[n]):] == 0.0)


def _level_close(u, h0, b):
    """The plain K3 against the Pallas kernel in interpret mode, at the
    JAX kernel test's tolerances."""
    ker = np.asarray(JK.gwf_waterfill(jnp.asarray(u), jnp.asarray(h0), b,
                                      interpret=True))
    out = np_(PR.gwf_waterfill_ref(f32(u), f32(h0), b))
    np.testing.assert_allclose(out, ker, atol=1e-2 * max(1, b / 10),
                               rtol=1e-3)
    assert abs(float(out.sum()) - b) < 1e-3 * max(1.0, b)
    assert np.all(out[u <= 0] == 0.0)


# M = 37 and 5000 are shapes of chip_smoke.py's k3_options: part of one
# register-tile slot, and 904 bottles in shared memory
@pytest.mark.parametrize("M", [4, 100, 1500, 37, 5000])
@pytest.mark.parametrize("b", [0.5, 10.0, 200.0])
def test_level_plain_matches_pallas_interpret(M, b):
    rng = np.random.default_rng(M)
    u = rng.uniform(0.1, 5.0, M).astype(np.float32)
    h0 = rng.uniform(-2.0, 3.0, M).astype(np.float32)
    u[rng.random(M) < 0.25] = 0.0
    _level_close(u, h0, b)


# The other options of k3_options: one bottle; one active bottle of 100;
# b = 1e-3 with the bottoms at its scale; bottoms of both signs shifted
# so that the level sits at 0, where the float32 bisection takes the
# most steps.
@pytest.mark.parametrize("case", ["M1", "one_active", "b_1e-3",
                                  "level_near_0"])
def test_level_plain_matches_pallas_interpret_on_options(case):
    rng = np.random.default_rng(7)
    M, b = (1, 10.0) if case == "M1" else (100, 10.0)
    u = rng.uniform(0.1, 5.0, M)
    h0 = rng.uniform(-2.0, 3.0, M)
    if case == "one_active":
        u[1:] = 0.0
    elif case == "b_1e-3":
        b, h0 = 1e-3, 1e-3 * h0
    elif case == "level_near_0":
        h0 = rng.uniform(-1.0, 1.0, M)
        th = np_(PR.gwf_waterfill_ref(torch.tensor(u), torch.tensor(h0), b))
        part = (th > 0) & (th < b * (1 - 1e-4))
        h0 = h0 - np.median((h0 + th / u)[part])
    _level_close(u.astype(np.float32), h0.astype(np.float32), b)


def test_level_plain_gives_zeros_without_an_active_bottle():
    """Port only: no active bottle gives θ = 0, as the plain version's
    sort-based solve does and the CUDA kernel is built to.  The JAX Pallas
    kernel returns NaN there (its bracket is (+inf, −inf)), a reference
    caveat, so it is not compared."""
    h0 = f32(np.linspace(-2.0, 3.0, 37))
    for u in (torch.zeros(37), -torch.ones(37)):
        out = PR.gwf_waterfill_ref(u, h0, 5.0)
        assert out.dtype == torch.float32 and torch.equal(out,
                                                          torch.zeros(37))
        assert torch.equal(PO.gwf_waterfill_op(u, h0, 5.0, impl="cuda"), out)


def test_ops_cuda_impl_on_cpu_runs_the_plain_version():
    sp = FAMILIES["log"]
    C, bs = _instances(3, 3, 9)
    par = [torch.full((3,), float(v), dtype=torch.float32)
           for v in (sp.A, sp.w, sp.gamma)]
    for impl in ("cuda", "auto"):
        out = PO.generic_waterfill_op(f32(C), *par, f32(bs), sigma=1,
                                      impl=impl)
        ref = PR.generic_waterfill_ref(f32(C), *par, f32(bs), sigma=1)
        assert torch.equal(out, ref)
    arrs, hb, _ = _mixed(14, N=3, K=16, m_range=(3, 16))
    for impl in ("cuda", "auto"):
        out = PO.hetero_waterfill_op(*map(f32, arrs), f32(hb), impl=impl)
        assert torch.equal(out, PR.hetero_waterfill_ref(*map(f32, arrs),
                                                        f32(hb)))
    u, h0 = f32(np.linspace(1.0, 2.0, 7)), f32(np.linspace(0.0, 1.0, 7))
    assert torch.equal(PO.gwf_waterfill_op(u, h0, 3.0, impl="cuda"),
                       PR.gwf_waterfill_ref(u, h0, 3.0))
    # the sorted impl is the core solver, not a bisection (float64 here;
    # tolerance of tests/kernels/test_hetero_waterfill.py:50)
    a64 = [torch.tensor(a, dtype=torch.float64) for a in arrs]
    b64 = torch.tensor(hb, dtype=torch.float64)
    srt = PO.hetero_waterfill_op(*a64, b64, impl="sorted")
    np.testing.assert_allclose(np_(srt), np_(PR.hetero_waterfill_ref(
        *a64, b64)), atol=2e-5 * float(hb.max()))
    with pytest.raises(ValueError):
        PO.generic_waterfill_op(f32(C), *par, f32(bs), impl="pallas")


def test_kernel_wrappers_refuse_cpu_tensors():
    C, bs = _instances(4, 2, 8)
    one = torch.ones(2)
    with pytest.raises(ValueError, match="CUDA tensors"):
        PK.generic_waterfill(f32(C), one, one, -0.5 * one, f32(bs))
    with pytest.raises(ValueError, match="CUDA tensors"):
        PK.hetero_waterfill(f32(C), f32(C), f32(C), f32(C), f32(C), f32(bs))
    with pytest.raises(ValueError, match="CUDA tensors"):
        PK.gwf_waterfill(f32(C[0]), f32(C[0]), 1.0)
    assert PK.LAUNCHES == {"generic_waterfill": 0, "hetero_waterfill": 0,
                           "gwf_waterfill": 0}


# K, block size, fields a job → (jobs a thread, in registers, in shared
# memory, streamed, shared-memory bytes)
@pytest.mark.parametrize("K, threads, fields, want", [
    (1, 1024, 3, (4, 1, 0, 0, 0)),
    (37, 256, 6, (16, 37, 0, 0, 0)),
    (4096, 512, 6, (8, 4096, 0, 0, 0)),
    (5000, 1024, 3, (4, 4096, 904, 0, 904 * 12)),
    (5000, 256, 6, (16, 4096, 904, 0, 904 * 24)),
    (65536, 1024, 3, (4, 4096, 16384, 45056, 196608)),
    (65536, 256, 6, (16, 4096, 8192, 53248, 196608)),
    (5000, 256, 2, (16, 4096, 904, 0, 904 * 8)),
    (65536, 256, 2, (16, 4096, 24576, 36864, 196608)),
    (65536, 1024, 2, (4, 4096, 24576, 36864, 196608)),
])
def test_job_tiles_split_registers_shared_memory_and_streamed(
        K, threads, fields, want):
    assert tuple(PK.job_tiles(K, threads, fields)) == want


def test_job_tiles_refuse_other_block_sizes_and_match_the_source():
    with pytest.raises(ValueError, match="256, 512 or 1024"):
        PK.job_tiles(100, 128, 3)
    src = _build.SOURCES["gwf_waterfill"].read_text()
    assert f"constexpr int kTileJobs = {PK.TILE_JOBS};" in src
    assert f"constexpr int kSmemBytes = {PK.SMEM_BYTES};" in src
    assert sorted(PK.FIELDS) == sorted(PK.THREADS) == sorted(PK.LAUNCHES)
    for name, fields in PK.FIELDS.items():
        # the entry point of each kernel checks the tile of its own fields
        assert re.search(rf"{name}_f32\(.*?smem_jobs_for\([KM], {fields}\)",
                         src, re.S)
        assert PK.THREADS[name] in (256, 512, 1024)
    assert PK.SMEM_BYTES <= 227 * 1024      # a block's dynamic maximum


def test_generic_args_pass_float32_at_element_strides():
    c = torch.rand(3, 5)
    shared = torch.tensor(0.5, dtype=torch.float64).expand(3)
    w = torch.tensor([1.0, 2.0, 3.0])
    every_other = torch.arange(6.0)[::2]
    b = torch.arange(6, dtype=torch.float64)[::2]
    cf, vals = PK.generic_args(c, shared, w, -0.5, b)
    assert cf.data_ptr() == c.data_ptr() and cf.dtype == torch.float32
    assert all(t.dtype == torch.float32 for t, _ in vals)
    (At, sA), (wt, sw), (gt, sg), (bt, sb) = vals
    assert (sA, sw, sg, sb) == (0, 1, 0, 1)

    def first(t):        # the element the kernel reads at stride 0
        return t.reshape(-1)[0].item()

    assert At.numel() == 1 and first(At) == 0.5 and first(gt) == -0.5
    assert bt.tolist() == [0.0, 2.0, 4.0]
    # float32 is passed as it lies, strided or expanded
    assert wt.data_ptr() == w.data_ptr()
    expanded = torch.tensor([-0.5]).expand(3)
    (_, (wt, sw), (gt, sg), _) = PK.generic_args(c, 1, every_other,
                                                 expanded, b)[1]
    assert wt.data_ptr() == every_other.data_ptr() and sw == 2
    assert sg == 0 and gt.data_ptr() == expanded.data_ptr()
    # c other than contiguous float32 becomes a contiguous float32 copy
    ct = c.double().t().contiguous().t()
    cf = PK.generic_args(ct, 1, 1, 1, 1)[0]
    assert cf.dtype == torch.float32 and cf.is_contiguous()
    assert torch.equal(cf, c)
    with pytest.raises(ValueError, match="per-instance value"):
        PK.generic_args(c, torch.ones(4), w, -0.5, b)


def test_cuda_paths_launch_without_a_host_bracket(monkeypatch):
    def no_bracket(*args, **kw):
        raise AssertionError("the CUDA path computed a bracket on the host")

    monkeypatch.setattr(PR, "lam_bracket", no_bracket)
    with pytest.raises(ValueError, match="CUDA tensors"):
        PK.generic_waterfill(torch.rand(2, 8), 1.0, 4.0, -0.5, torch.ones(2))
    # past the device check the launch takes the argument plan, and no
    # other kernel runs: the bracket is the kernel's
    calls = []
    monkeypatch.setattr(PK, "_check_cuda", lambda c, ndim: None)
    monkeypatch.setattr(PK, "_launch", lambda *args: calls.append(args))
    c = torch.rand(2, 5000)
    out = PK.generic_waterfill(c, 1.0, 4.0, -0.5, torch.ones(2), sigma=-1,
                               iters=16)
    assert out.shape == (2, 5000) and out.dtype == torch.float32
    out = PK.hetero_waterfill(*[torch.rand(3, 65536)] * 5, torch.ones(3))
    assert out.shape == (3, 65536)
    (k1, counter1, _, *args1), (k2, counter2, _, *args2) = calls
    assert (k1, counter1) == ("generic_waterfill_f32", "generic_waterfill")
    assert (k2, counter2) == ("hetero_waterfill_f32", "hetero_waterfill")
    for name, args in ((k1, args1), (k2, args2)):
        assert len(args) == len(PK._SIGNATURES[name])
    ints = [[a.value for a in args if isinstance(a, ctypes.c_int)]
            for args in (args1, args2)]
    # K1: sA, sw, sg, sb, N, K, iters, sigma, threads, shared-memory jobs
    assert ints[0] == [0, 0, 0, 1, 2, 5000, 16, -1,
                       PK.THREADS["generic_waterfill"], 904]
    # K2: N, K, iters, threads, shared-memory jobs
    assert ints[1] == [3, 65536, 64, PK.THREADS["hetero_waterfill"], 8192]


def test_level_launch_passes_block_size_and_tile(monkeypatch):
    calls = []
    monkeypatch.setattr(PK, "_check_cuda", lambda c, ndim: None)
    monkeypatch.setattr(PK, "_launch", lambda *args: calls.append(args))
    for M, iters in ((37, 64), (5000, 16), (65536, 64)):
        out = PK.gwf_waterfill(torch.rand(M), torch.rand(M).double(), 2.5,
                               iters=iters)
        assert out.shape == (M,) and out.dtype == torch.float32
    threads = PK.THREADS["gwf_waterfill"]
    for (name, counter, _, *args), (M, iters, smem) in zip(
            calls, ((37, 64, 0), (5000, 16, 904), (65536, 64, 24576))):
        assert (name, counter) == ("gwf_waterfill_f32", "gwf_waterfill")
        assert len(args) == len(PK._SIGNATURES[name])
        assert args[2].value == 2.5
        # M, iters, threads, shared-memory bottles
        assert [a.value for a in args if isinstance(a, ctypes.c_int)] == [
            M, iters, threads, smem]
        assert smem == PK.job_tiles(M, threads, 2).smem_jobs


def test_build_command_targets_sm90a_into_build_dir():
    assert sorted(_build.SOURCES) == ["flash_attention",
                                      "flash_attention_bwd",
                                      "gwf_waterfill", "linear_scan",
                                      "linear_scan_bwd"]
    for name in _build.SOURCES:
        cmd = _build.nvcc_command(name)
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert "-shared" in cmd and "-std=c++17" in cmd
        out = cmd[cmd.index("-o") + 1]
        assert out.startswith(str(_build.BUILD_DIR))
        assert cmd[-1].endswith(f"csrc/{name}.cu")
        assert _build.SOURCES[name].is_file()
    assert _build.BUILD_DIR.parts[-2:] == ("build", "repro_torch_kernels")


def test_build_dir_is_the_checkout_root_or_an_explicit_setting(tmp_path):
    root = Path(__file__).resolve().parents[1]
    assert _build.BUILD_DIR == root / "build" / "repro_torch_kernels"
    # an installed package (no pyproject.toml above it) never builds
    # beside site-packages
    pkg = tmp_path / "site-packages" / "repro_torch" / "kernels"
    pkg.mkdir(parents=True)
    env = {_build.BUILD_ENV: str(tmp_path / "kernels")}
    assert _build.resolve_build_dir(pkg, env) == tmp_path / "kernels"
    assert _build.resolve_build_dir(pkg, {}) == (
        Path.home() / ".cache" / "repro_torch_kernels")
    (tmp_path / "pyproject.toml").write_text("")
    assert _build.resolve_build_dir(pkg, env) == tmp_path / "kernels"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "none"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build_all()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("gwf_waterfill")
    assert not (tmp_path / "build").exists()
