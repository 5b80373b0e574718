"""Port vs JAX: the plain versions of the flash attention and linear scan
kernels (K5, K4).

Each plain version (``repro_torch.kernels.{flash_attention,
linear_scan}.ref``) is held against the JAX package's own plain version
and its Pallas kernel run in interpret mode, as ``tests/kernels/`` runs
it on the CPU, on the same inputs made with numpy, at the JAX kernel
tests' tolerances.  The CUDA kernels themselves are held against these
plain versions on the card by ``chip_smoke.py``.
"""
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
    assert FK.LAUNCHES == {"flash_attention": 0}
    assert SK.LAUNCHES == {"linear_scan": 0}


def test_kernel_wrappers_refuse_cpu_tensors():
    (_, qt), (_, kt), (_, vt) = qkv(1, 8, 8, 2, 1, 16, "f32")
    with pytest.raises(ValueError, match="CUDA tensors"):
        FK.flash_attention(qt, kt, vt)
    (_, at), (_, bt) = ab(1, 8, 4, "f32")
    with pytest.raises(ValueError, match="CUDA tensors"):
        SK.linear_scan(at, bt)
    assert FK.LAUNCHES == {"flash_attention": 0}
    assert SK.LAUNCHES == {"linear_scan": 0}


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
    assert sorted(reports) == ["flash_attention", "gwf_waterfill",
                               "linear_scan"]
    kinds = [e[0] for e in events]
    assert kinds == ["start"] * 3 + ["wait"] * 3
    assert {e[1].rsplit("/", 1)[-1] for e in events} == {
        "flash_attention.cu", "gwf_waterfill.cu", "linear_scan.cu"}
