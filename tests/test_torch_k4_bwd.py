"""Port vs JAX: K4's backward — the reverse linear scan — and its wiring.

The card's backward kernel (``csrc/linear_scan_bwd.cu``) is held against
its plain version in ``chip_smoke.py`` phase 19; here the plain version
and everything around the kernel are held against the JAX package on the
CPU, with inputs from a seeded numpy generator:

* ``linear_scan_bwd_ref`` against ``jax.vjp`` of the JAX package's
  ``linear_scan_ref``: f32 to rtol 1e-5 (atol 1e-6 of the largest
  gradient); bf16 to one bf16 rounding step of the largest gradient (the
  plain backward reads the saved h in bf16, JAX's its f32 state);
* the port's ``chunked_linear_scan`` gradients (the inputs and h0, chunk
  32, S not a multiple of it) against ``jax.vjp`` of the JAX package's,
  through the plain scan and through ``LinearScan``, to rtol 1e-5;
* ``scan_bwd_geometry`` on the shapes phase 19 drives, and its constants
  against the source's;
* ``LinearScan``'s wiring: with the op told the tensors are the card's
  and the two kernel entries replaced by their plain versions (counted as
  the kernels are), the RG-LRU and Mamba smoke configs' ``model_apply``
  gradients under remat none, full and dots equal
  ``jax.value_and_grad(model_apply)``'s at ``test_torch_train_model.py``'s
  tolerances, with the launches each remat mode must make.
"""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.models as JM
from repro.kernels.linear_scan.ref import linear_scan_ref as j_scan
from repro.models.scan_ops import chunked_linear_scan as j_chunked
import repro_torch.configs as PC
from repro_torch.convert import params_from_arrays
from repro_torch.kernels import _build
from repro_torch.kernels.linear_scan import kernel as SK
from repro_torch.kernels.linear_scan import ops as SO
from repro_torch.kernels.linear_scan.ref import (linear_scan_bwd_ref,
                                                 linear_scan_ref)
from repro_torch.models.scan_ops import chunked_linear_scan
from test_torch_train_model import (ATOL, RTOL, assert_grads_close,
                                    make_batch, port_grads)


def scan_inputs(shape, seed=0):
    """a in (0.8, 1) as RG-LRU's gates are, b and dh standard normal."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.8, 1.0, shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32)
    dh = rng.standard_normal(shape).astype(np.float32)
    return a, b, dh


@pytest.mark.parametrize("shape", [(2, 1, 5), (2, 40, 7), (3, 97, 4)])
def test_plain_backward_matches_jax_vjp_in_f32(shape):
    a, b, dh = scan_inputs(shape)
    h, vjp = jax.vjp(j_scan, a, b)
    ja, jb = vjp(dh)
    da, db = linear_scan_bwd_ref(torch.tensor(a), torch.tensor(np.asarray(h)),
                                 torch.tensor(dh))
    for got, ref in ((da, ja), (db, jb)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-6 * np.abs(ref).max())


def bf16_step(x):
    """One bf16 rounding step (ulp) at the largest |x|."""
    return 2.0 ** (np.floor(np.log2(np.abs(x).max())) - 7)


@pytest.mark.parametrize("shape", [(2, 40, 7), (1, 130, 3)])
def test_plain_backward_matches_jax_vjp_in_bf16(shape):
    a, b, dh = scan_inputs(shape, seed=1)
    a16, b16, dh16 = (jnp.asarray(x, jnp.bfloat16) for x in (a, b, dh))
    h, vjp = jax.vjp(j_scan, a16, b16)
    ja, jb = vjp(dh16)
    t16 = [torch.tensor(np.asarray(x, np.float32)).bfloat16()
           for x in (a16, h, dh16)]
    da, db = linear_scan_bwd_ref(*t16)
    assert da.dtype == db.dtype == torch.bfloat16
    for got, ref in ((da, ja), (db, jb)):
        ref = np.asarray(ref, np.float32)
        np.testing.assert_allclose(got.float().numpy(), ref, rtol=0,
                                   atol=bf16_step(ref))


def plain_kernels(monkeypatch):
    """The op told its tensors are the card's, and K4's two kernel entries
    replaced by their plain versions, counted as the kernels are (in a
    fresh ``LAUNCHES`` that the test's end puts back); the plain scan
    itself raises if the op takes it."""
    def fwd(a, b):
        SK.LAUNCHES["linear_scan"] += 1
        return linear_scan_ref(a, b)

    def bwd(a, h, dh):
        SK.LAUNCHES["linear_scan_bwd"] += 1
        return linear_scan_bwd_ref(a, h, dh)

    def plain(a, b):
        raise AssertionError("the op took the plain scan")

    monkeypatch.setattr(SO, "use_cuda_for", lambda x, impl: impl != "ref")
    monkeypatch.setattr(SO, "linear_scan", fwd)
    monkeypatch.setattr(SO, "linear_scan_bwd", bwd)
    monkeypatch.setattr(SO, "linear_scan_ref", plain)
    monkeypatch.setattr(SK, "LAUNCHES", dict.fromkeys(SK.LAUNCHES, 0))


B, S, D, C = 2, 70, 6, 32          # 3 chunks of 32, the last one ragged


def chunked_inputs(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    z = rng.standard_normal((B, S, D)).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    wy = rng.standard_normal((B, S, D)).astype(np.float32)
    wh = rng.standard_normal((B, D)).astype(np.float32)
    return x, z, h0, wy, wh


def chunked_loss(scan, sig, x, z, h0, wy, wh):
    """Σ wy·y + Σ wh·h_S of a gated recurrence (a = σ(z),
    b = (1 − a)·x, y = h·x) through ``scan`` (either package's
    chunked_linear_scan)."""
    def make_ab(ci):
        a = sig(ci["z"])
        return a, (1.0 - a) * ci["x"]

    def emit(ci, h):
        return h * ci["x"]

    y, h = scan({"x": x, "z": z}, h0, make_ab, emit, chunk=C)
    return (y * wy).sum() + (h * wh).sum()


@pytest.mark.parametrize("path", ["plain_scan", "linear_scan_function"])
def test_chunked_scan_grads_match_jax(path, monkeypatch):
    x, z, h0, wy, wh = chunked_inputs()
    ref = jax.grad(lambda *xs: chunked_loss(j_chunked, jax.nn.sigmoid, *xs,
                                            wy, wh), argnums=(0, 1, 2))(
        x, z, h0)
    if path == "linear_scan_function":
        plain_kernels(monkeypatch)
    ins = [torch.tensor(v, requires_grad=True) for v in (x, z, h0)]
    loss = chunked_loss(chunked_linear_scan, torch.sigmoid, *ins,
                        torch.tensor(wy), torch.tensor(wh))
    got = torch.autograd.grad(loss, ins)
    for g, r, name in zip(got, ref, ("x", "z", "h0")):
        r = np.asarray(r)
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5,
                                   atol=1e-6 * np.abs(r).max(), err_msg=name)
    n = -(-S // C)
    want = ({"linear_scan": n, "linear_scan_bwd": n}
            if path == "linear_scan_function"
            else {"linear_scan": 0, "linear_scan_bwd": 0})
    assert SK.LAUNCHES == want


# (B, S, D) of phase 19: RG-LRU's and Mamba's path shapes, then
# chip_smoke.K4_OPTIONS
GEOMETRY_SHAPES = [(2, 4096, 2560), (2, 256, 131072), (2, 1, 2560),
                   (2, 40, 2560), (3, 1000, 2560), (1, 777, 96),
                   (1, 65536, 64)]


@pytest.mark.parametrize("shape", GEOMETRY_SHAPES)
def test_scan_bwd_geometry_on_the_phase_shapes(shape):
    Bn, Sn, Dn = shape
    geo = SK.scan_bwd_geometry(Bn, Sn, Dn)
    n_chunks = -(-Sn // SK.BWD_CHUNK)
    n_dtiles = -(-Dn // SK.LANES)
    assert (geo.n_chunks, geo.n_dtiles) == (n_chunks, n_dtiles)
    assert geo.blocks == n_chunks * Bn * n_dtiles < 2 ** 31
    assert geo.flag_ints == 1 + geo.blocks
    assert geo.carry_floats == 3 * n_chunks * Bn * Dn
    # every chunk but the last is whole; the last holds 1..BWD_CHUNK steps
    assert 0 < Sn - (n_chunks - 1) * SK.BWD_CHUNK <= SK.BWD_CHUNK
    src = _build.SOURCES["linear_scan_bwd"].read_text()
    assert f"constexpr int kChunk = {SK.BWD_CHUNK};" in src
    assert f"constexpr int kLanes = {SK.LANES};" in src
    assert re.search(r"__launch_bounds__\(kLanes, \d\)", src)


def test_backward_wrapper_refuses_cpu_tensors_and_counts_nothing():
    a, b, dh = (torch.tensor(v) for v in scan_inputs((1, 8, 4)))
    SK.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        SK.linear_scan_bwd(a, b, dh)
    assert SK.LAUNCHES == {"linear_scan": 0, "linear_scan_bwd": 0}
    assert _build.SOURCES["linear_scan_bwd"].name == "linear_scan_bwd.cu"


@pytest.fixture(scope="module", params=["recurrentgemma-2b",
                                        "falcon-mamba-7b"])
def scan_case(request):
    jcfg = JC.get_config(request.param, smoke=True)
    pcfg = PC.get_config(request.param, smoke=True)
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    batch = make_batch(jcfg)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: JM.model_apply(p, b, jcfg), has_aux=True))
    (jtotal, _), jgrads = fn(params, batch)
    tree = jax.tree_util.tree_map(np.asarray, params)
    model = params_from_arrays(pcfg, tree, device="cpu", trainable=True)
    return (pcfg, model, batch, float(jtotal),
            jax.tree_util.tree_map(np.asarray, jgrads))


def scan_calls(cfg, seq):
    """K4 calls of one forward of ``cfg``: one a RG-LRU layer, one a chunk
    of each Mamba layer."""
    kinds = [cfg.cycle[i % len(cfg.cycle)] for i in range(cfg.n_layers)]
    return (kinds.count("rglru")
            + kinds.count("mamba") * -(-seq // min(cfg.scan_chunk, seq)))


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_linear_scan_function_trains_the_scan_archs_as_jax(scan_case, remat,
                                                           monkeypatch):
    cfg, model, batch, jtotal, jgrads = scan_case
    plain_kernels(monkeypatch)
    model.cfg = cfg.replace(remat=remat)
    try:
        total, _, grads = port_grads(model, batch)
    finally:
        model.cfg = cfg
    np.testing.assert_allclose(float(total.detach()), jtotal, rtol=RTOL,
                               atol=ATOL)
    assert_grads_close(cfg, model, grads, jgrads)
    n = scan_calls(cfg, batch["tokens"].shape[1])
    assert n > 0
    # remat recomputes each layer's forward, K4 included, in the backward
    assert SK.LAUNCHES == {"linear_scan": n * (1 if remat == "none" else 2),
                           "linear_scan_bwd": n}
