"""Port vs JAX: the plain versions of the flash attention and linear scan
kernels (K5, K4).

Each plain version (``repro_torch.kernels.{flash_attention,
linear_scan}.ref``) is held against the JAX package's own plain version
and its Pallas kernel run in interpret mode, as ``tests/kernels/`` runs
it on the CPU, on the same inputs made with numpy, at the JAX kernel
tests' tolerances.  The CUDA kernels themselves are held against these
plain versions on the card by ``chip_smoke.py``.  What surrounds them in
Python is tested here too: K4's launch geometry and scratch sizes, K5's
rule for 16-byte copies, and the build's ptxas and SASS readers that
``chip_smoke.py`` reports registers, spills and tensor-core instructions
with.
"""
from pathlib import Path
from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as j_flash
from repro.kernels.flash_attention.ref import attention_ref as j_attn_ref
from repro.kernels.linear_scan.kernel import linear_scan as j_scan
from repro.kernels.linear_scan.ref import linear_scan_ref as j_scan_ref
from repro.models.attention import flash_attention_xla
from repro.models.scan_ops import chunked_linear_scan
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as FO
from repro_torch.kernels.linear_scan import kernel as SK
from repro_torch.kernels.linear_scan import ops as SO

DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}

# B, S, T, H, K, hd — tests/kernels/test_flash_attention.py's sweep
ATTN_SHAPES = [
    (2, 128, 128, 4, 2, 64),     # GQA
    (1, 256, 256, 8, 8, 64),     # MHA
    (2, 192, 192, 4, 1, 128),    # MQA, odd-ish seq
    (1, 64, 320, 4, 2, 64),      # cross-length
    (1, 96, 96, 2, 2, 256),      # big head_dim (recurrentgemma)
]
SCAN_SHAPES = [(2, 64, 128), (1, 100, 256), (3, 128, 96), (2, 256, 512)]


def both(x, dtype):
    """One numpy array as a JAX array and a CPU tensor of ``dtype`` (both
    round f32 to bf16 to nearest even, so the two hold equal numbers)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.tensor(x).to(td)


def f32(x):
    return np.asarray(jnp.asarray(x).astype(jnp.float32)) if not isinstance(
        x, torch.Tensor) else x.float().numpy()


def qkv(B, S, T, H, K, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, S, H, hd), np.float32) * 0.2
    k = rng.standard_normal((B, T, K, hd), np.float32) * 0.2
    v = rng.standard_normal((B, T, K, hd), np.float32)
    return [both(x, dtype) for x in (q, k, v)]


def ab(B, S, D, dtype, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.8, 0.999, (B, S, D)).astype(np.float32)
    b = (rng.standard_normal((B, S, D)) * 0.1).astype(np.float32)
    return both(a, dtype), both(b, dtype)


@pytest.mark.parametrize("shape", ATTN_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_attention_ref_matches_jax(shape, dtype):
    B, S, T, H, K, hd = shape
    (qj, qt), (kj, kt), (vj, vt) = qkv(*shape, dtype)
    causal = S == T
    out = FO.attention_ref(qt, kt, vt, causal=causal)
    assert out.dtype == qt.dtype and out.shape == (B, S, H, hd)
    tol = 2e-5 if dtype == "f32" else 2e-2
    for ref in (j_attn_ref(qj, kj, vj, causal=causal),
                j_flash(qj, kj, vj, causal=causal, block_q=64, block_kv=128,
                        interpret=True)):
        np.testing.assert_allclose(f32(out), f32(ref), atol=tol, rtol=tol)


@pytest.mark.parametrize("window", [32, 64])
def test_attention_ref_sliding_window(window):
    (qj, qt), (kj, kt), (vj, vt) = qkv(2, 128, 128, 4, 2, 64, "f32")
    out = FO.attention_ref(qt, kt, vt, causal=True, window=window)
    for ref in (j_attn_ref(qj, kj, vj, causal=True, window=window),
                j_flash(qj, kj, vj, causal=True, window=window, block_q=32,
                        block_kv=64, interpret=True)):
        np.testing.assert_allclose(f32(out), f32(ref), atol=2e-5)
    # the window masks: without it the result moves well past 2e-5
    wide = FO.attention_ref(qt, kt, vt, causal=True)
    assert float((wide - out).abs().max()) > 1e-2


def test_attention_ref_softcap():
    (qj, qt), (kj, kt), (vj, vt) = qkv(1, 128, 128, 4, 4, 64, "f32")
    out = FO.attention_ref(qt, kt, vt, causal=True, cap=50.0)
    for ref in (j_attn_ref(qj, kj, vj, causal=True, cap=50.0),
                j_flash(qj, kj, vj, causal=True, cap=50.0, block_q=64,
                        block_kv=64, interpret=True)):
        np.testing.assert_allclose(f32(out), f32(ref), atol=2e-5)


def test_attention_ref_matches_model_path():
    """The JAX models' XLA flash path, which the port's model routes
    through K5, agrees with the port's plain version."""
    (qj, qt), (kj, kt), (vj, vt) = qkv(2, 160, 160, 4, 2, 64, "f32")
    ref = flash_attention_xla(qj, kj, vj, causal=True, window=48, cap=50.0,
                              q_block=64, kv_block=64)
    out = FO.attention_ref(qt, kt, vt, causal=True, window=48, cap=50.0)
    np.testing.assert_allclose(f32(out), f32(ref), atol=2e-5)


@pytest.mark.parametrize("shape", SCAN_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_linear_scan_ref_matches_jax(shape, dtype):
    (aj, at), (bj, bt) = ab(*shape, dtype)
    out = SO.linear_scan_ref(at, bt)
    assert out.dtype == at.dtype and out.shape == at.shape
    tol = 1e-4 if dtype == "f32" else 3e-2
    for ref in (j_scan_ref(aj, bj),
                j_scan(aj, bj, chunk=32, block_d=128, interpret=True)):
        np.testing.assert_allclose(f32(out), f32(ref), atol=tol, rtol=tol)


def test_linear_scan_ref_matches_model_substrate():
    (aj, at), (bj, bt) = ab(2, 96, 64, "f32")
    y, h_last = chunked_linear_scan(
        {"a": aj, "b": bj}, jnp.zeros((2, 64), jnp.float32),
        lambda ci: (ci["a"], ci["b"]), lambda ci, h: h, chunk=32)
    out = SO.linear_scan_ref(at, bt)
    np.testing.assert_allclose(f32(out), f32(y), atol=1e-5)
    # the last step is the decode state the port takes from the same call
    np.testing.assert_allclose(f32(out[:, -1]), f32(h_last), atol=1e-5)


def test_ops_run_the_plain_version_on_cpu_tensors():
    (_, qt), (_, kt), (_, vt) = qkv(1, 40, 40, 4, 1, 32, "f32")
    ref = FO.attention_ref(qt, kt, vt, causal=True, window=16, cap=30.0)
    for impl in ("auto", "cuda", "ref"):
        out = FO.flash_attention_op(qt, kt, vt, causal=True, window=16,
                                    cap=30.0, impl=impl)
        assert torch.equal(out, ref)
    (_, at), (_, bt) = ab(2, 17, 8, "f32")
    ref = SO.linear_scan_ref(at, bt)
    for impl in ("auto", "cuda", "ref"):
        assert torch.equal(SO.linear_scan_op(at, bt, impl=impl), ref)
    with pytest.raises(ValueError, match="unknown impl"):
        FO.flash_attention_op(qt, kt, vt, impl="pallas")
    with pytest.raises(ValueError, match="unknown impl"):
        SO.linear_scan_op(at, bt, impl="interpret")
    assert FK.LAUNCHES == {"flash_attention": 0,
                          "flash_attention_bwd": 0}
    assert SK.LAUNCHES == {"linear_scan": 0, "linear_scan_bwd": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    (_, qt), (_, kt), (_, vt) = qkv(1, 8, 8, 2, 1, 16, "f32")
    with pytest.raises(ValueError, match="CUDA tensors"):
        FK.flash_attention(qt, kt, vt)
    (_, at), (_, bt) = ab(1, 8, 4, "f32")
    with pytest.raises(ValueError, match="CUDA tensors"):
        SK.linear_scan(at, bt)
    assert FK.LAUNCHES == {"flash_attention": 0,
                          "flash_attention_bwd": 0}
    assert SK.LAUNCHES == {"linear_scan": 0, "linear_scan_bwd": 0}


def test_build_starts_one_nvcc_per_source_all_at_once(monkeypatch, tmp_path):
    """build_all starts every compiler before it waits on any."""
    events = []

    class FakeProc:
        def __init__(self, cmd, **kw):
            self.name = cmd[-1]
            self.returncode = 0
            events.append(("start", self.name))

        def communicate(self):
            events.append(("wait", self.name))
            return "ptxas info: Used 32 registers", None

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    with mock.patch.object(_build.subprocess, "Popen", FakeProc):
        reports = _build.build_all()
    assert sorted(reports) == ["flash_attention", "flash_attention_bwd",
                               "gwf_waterfill", "linear_scan",
                               "linear_scan_bwd"]
    kinds = [e[0] for e in events]
    assert kinds == ["start"] * 5 + ["wait"] * 5
    assert {e[1].rsplit("/", 1)[-1] for e in events} == {
        "flash_attention.cu", "flash_attention_bwd.cu", "gwf_waterfill.cu",
        "linear_scan.cu", "linear_scan_bwd.cu"}


# (B, S, D) of chip_smoke.py's K4_OPTIONS: one step, under one chunk,
# ragged chunks, ragged lanes, a long look-back chain, the serving shape
@pytest.mark.parametrize("shape", [(2, 1, 2560), (2, 40, 2560),
                                   (3, 1000, 2560), (1, 777, 96),
                                   (1, 65536, 64), (2, 4096, 2560)])
def test_scan_geometry_covers_the_option_shapes(shape):
    B, S, D = shape
    geo = SK.scan_geometry(B, S, D)
    # every step and channel lies in one block: chunks × d tiles cover
    # S × D with less than one chunk and one tile to spare
    assert 0 <= geo.n_chunks * SK.CHUNK - S < SK.CHUNK
    assert 0 <= geo.n_dtiles * SK.LANES - D < SK.LANES
    assert geo.blocks == geo.n_chunks * B * geo.n_dtiles
    # the ticket counter and one flag a block; per chunk and lane the
    # composite (a, b) and the inclusive prefix
    assert geo.flag_ints == 1 + geo.blocks
    assert geo.carry_floats == 3 * geo.n_chunks * B * D
    assert geo.blocks < 2 ** 31


def test_scan_geometry_of_the_serving_shape():
    assert SK.scan_geometry(2, 4096, 2560) == SK.ScanGeometry(
        n_chunks=64, n_dtiles=20, blocks=2560, flag_ints=2561,
        carry_floats=983040)


PTXAS_REPORT = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_122flash_attention_kernelI13__nv_bfloat16Li256EEEvPKT_S4_S4_PS2_iiiiiiiifii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_122flash_attention_kernelI13__nv_bfloat16Li256EEEvPKT_S4_S4_PS2_iiiiiiiifii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 245 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_118linear_scan_kernelIfEEvPKT_S3_PS1_iiiiiPiPf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_118linear_scan_kernelIfEEvPKT_S3_PS1_iiiiiPiPf
    48 bytes stack frame, 44 bytes spill stores, 44 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 8 bytes smem
"""


def test_ptxas_usage_reads_registers_and_spills_per_kernel():
    got = {_build.kernel_label(fn): u
           for fn, u in _build.ptxas_usage(PTXAS_REPORT).items()}
    assert got == {
        "flash_attention_kernel<bf16,256>": {
            "stack_bytes": 0, "spill_store_bytes": 0, "spill_load_bytes": 0,
            "registers": 245},
        "linear_scan_kernel<f32>": {
            "stack_bytes": 48, "spill_store_bytes": 44,
            "spill_load_bytes": 44, "registers": 168}}


def test_kernel_label_names_type_and_width():
    assert _build.kernel_label(
        "_ZN12_GLOBAL__N_122flash_attention_kernelIfLi64EEEvPKT_S3_S3_PS1_"
        "iiiiiiiifii") == "flash_attention_kernel<f32,64>"
    assert _build.kernel_label(
        "_ZN12_GLOBAL__N_118linear_scan_kernelI13__nv_bfloat16EEvPKT_S4_"
        "PS2_iiiiiPiPf") == "linear_scan_kernel<bf16>"
    assert _build.kernel_label(
        "_ZN12_GLOBAL__N_124generic_waterfill_kernelEPKfS1_") == \
        "generic_waterfill_kernel"
    assert _build.kernel_label(
        "_ZN12_GLOBAL__N_123hetero_waterfill_kernelILi256EEEvPKfS2_S2_S2_"
        "S2_S2_Pfiii") == "hetero_waterfill_kernel<256>"


SASS = """\
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_122flash_attention_kernelI13__nv_bfloat16Li64EEEvPKT_S4_S4_PS2_iiiiiiiifii
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], R24, gsb0 ;
        /*0020*/              @!P0 HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], R24, gsb0 ;
        /*0030*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
\t\tFunction : _ZN12_GLOBAL__N_122flash_attention_kernelIfLi64EEEvPKT_S3_S3_PS1_iiiiiiiifii
        /*0000*/                   FFMA R4, R5, R6, R4 ;
"""


def test_sass_counts_tensor_core_instructions_per_kernel():
    got = {_build.kernel_label(fn): c for fn, c in
           _build.sass_counts(SASS, ("HMMA", "HGMMA")).items()}
    assert got == {"flash_attention_kernel<bf16,64>": {"HMMA": 1, "HGMMA": 2},
                   "flash_attention_kernel<f32,64>": {"HMMA": 0, "HGMMA": 0}}


def test_copies_16_bytes_needs_whole_pieces_and_aligned_starts():
    x = torch.zeros(64, dtype=torch.bfloat16)
    assert x.data_ptr() % 16 == 0
    assert FK.copies_16_bytes(64, 2, x, x)
    assert FK.copies_16_bytes(8, 2, x)
    assert not FK.copies_16_bytes(12, 2, x)        # 24-byte rows
    assert not FK.copies_16_bytes(64, 2, x, x[1:])  # starts 2 bytes in
    assert FK.copies_16_bytes(4, 4, torch.zeros(8))  # f32: 4 a piece


def test_build_keeps_each_ptxas_report_beside_its_library(monkeypatch,
                                                          tmp_path):
    class FakeProc:
        def __init__(self, cmd, **kw):
            self.name = Path(cmd[-1]).stem
            self.returncode = 0

        def communicate(self):
            return f"ptxas info    : report of {self.name}", None

    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "find_nvcc", lambda: "nvcc")
    assert _build.ptxas_report("linear_scan") == ""
    with mock.patch.object(_build.subprocess, "Popen", FakeProc):
        _build.build_all()
    for name in _build.SOURCES:
        assert _build.ptxas_report(name) == f"ptxas info    : report of {name}"
        assert _build.library_path(name).parent == tmp_path / "build"
