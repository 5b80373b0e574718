"""Port vs JAX: Mamba (falcon-mamba-7b) and the chunked scan under it.

The same numpy inputs go through the JAX package's functions and the
port's (``device="cpu"``, where the linear scan kernel's plain version
stands in): ``chunked_linear_scan`` and ``assoc_linear_scan`` on ragged
lengths with a nonzero initial state (f32 to 1e-5), and on the smoke
config the first layer's ``mamba_apply``, the prefill's decode state
(h, conv) and ``mamba_decode`` (the serving tolerance, atol 2e-4 and
rtol 1e-3, of ``tests/models/test_serving.py``; the JAX weights go in
through ``params_from_arrays``).  A prompt of 1 or 2 tokens, shorter
than the conv window, is held to the port's own cache-free forward,
because the JAX package's prefill fails there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
import repro.models as JM
from repro.models import mamba as jmamba
from repro.models import scan_ops as jscan
from repro.models.transformer import _mamba_prefill
import repro_torch.configs as PC
import repro_torch.models as PM
from repro_torch.convert import params_from_arrays
from repro_torch.models import mamba as pmamba
from repro_torch.models import scan_ops as pscan
from repro_torch.models.transformer import Transformer

ARCH = "falcon-mamba-7b"
TOL = dict(atol=2e-4, rtol=1e-3)


def close(port, ref, **tol):
    np.testing.assert_allclose(port.detach().float().numpy(), np.asarray(ref),
                               **(tol or TOL))


# ---- the chunked scan ----------------------------------------------------------
def _scan_inputs(S, seed=0, B=2, F=3, N=4):
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(B, S, F, N)).astype(np.float32)
    h0 = rng.normal(size=(B, F, N)).astype(np.float32)
    return u, h0


def _jax_fns():
    def make_ab(ci):
        u = ci["u"]
        return jnp.exp(-jax.nn.softplus(u)), jnp.cos(u)

    def emit(ci, h):
        return (h * ci["u"]).sum(-1)
    return make_ab, emit


def _port_fns():
    def make_ab(ci):
        u = ci["u"]
        return torch.exp(-torch.nn.functional.softplus(u)), torch.cos(u)

    def emit(ci, h):
        return (h * ci["u"]).sum(-1)
    return make_ab, emit


@pytest.mark.parametrize("S,chunk", [(45, 16), (10, 16), (48, 16), (1, 8)])
def test_chunked_linear_scan_matches_jax(S, chunk):
    """Ragged S (not a multiple of the chunk), S under one chunk, whole
    chunks and one step, all from a nonzero h0."""
    u, h0 = _scan_inputs(S)
    yj, hj = jscan.chunked_linear_scan({"u": jnp.asarray(u)}, jnp.asarray(h0),
                                       *_jax_fns(), chunk=chunk)
    yp, hp = pscan.chunked_linear_scan({"u": torch.as_tensor(u)},
                                       torch.as_tensor(h0), *_port_fns(),
                                       chunk=chunk)
    assert yp.shape == (2, S, 3) and hp.shape == (2, 3, 4)
    assert hp.dtype == torch.float32
    close(yp, yj, atol=1e-5, rtol=1e-5)
    close(hp, hj, atol=1e-5, rtol=1e-5)


def test_chunked_scan_calls_the_kernel_op_once_a_chunk(monkeypatch):
    """One ``linear_scan_op`` call a chunk, each on (B, c, D) f32
    contiguous inputs with the feature axes flattened, c = min(chunk, S)."""
    calls = []
    real = pscan.linear_scan_op

    def counted(a, b, **kw):
        calls.append((tuple(a.shape), a.dtype, a.is_contiguous(),
                      b.is_contiguous()))
        return real(a, b, **kw)

    monkeypatch.setattr(pscan, "linear_scan_op", counted)
    u, h0 = _scan_inputs(45)
    pscan.chunked_linear_scan({"u": torch.as_tensor(u)}, torch.as_tensor(h0),
                              *_port_fns(), chunk=16)
    assert calls == [((2, 16, 12), torch.float32, True, True)] * 3
    calls.clear()
    pscan.chunked_linear_scan({"u": torch.as_tensor(u[:, :10])},
                              torch.as_tensor(h0), *_port_fns(), chunk=16)
    assert calls == [((2, 10, 12), torch.float32, True, True)]


def test_assoc_linear_scan_matches_jax():
    u, h0 = _scan_inputs(37, seed=3)
    a, b = np.exp(-np.logaddexp(u, 0)), np.cos(u)
    hj = jscan.assoc_linear_scan(jnp.asarray(a), jnp.asarray(b),
                                 jnp.asarray(h0))
    bt = torch.as_tensor(b)
    hp = pscan.assoc_linear_scan(torch.as_tensor(a), bt, torch.as_tensor(h0))
    close(hp, hj, atol=1e-5, rtol=1e-5)
    assert torch.equal(bt, torch.as_tensor(b))      # b is not overwritten
    with pytest.raises(NotImplementedError):
        pscan.assoc_linear_scan(torch.as_tensor(a), bt, torch.as_tensor(h0),
                                axis=2)


# ---- the Mamba block on the smoke config -------------------------------------
@pytest.fixture(scope="module")
def smoke():
    """(JAX cfg, JAX params, the port's model with the same numbers)."""
    jcfg = JC.get_config(ARCH, smoke=True)
    params = JM.init_params(jax.random.PRNGKey(0), jcfg)
    model = params_from_arrays(PC.get_config(ARCH, smoke=True),
                               jax.tree_util.tree_map(np.asarray, params),
                               device="cpu")
    return jcfg, params, model


def _layer(params, i=0):
    return jax.tree_util.tree_map(lambda x: x[i], params["blocks"][0]["mixer"])


def _x(S, seed=2, d=64, B=2):
    return np.random.default_rng(seed).normal(size=(B, S, d)).astype(
        np.float32)


@pytest.mark.parametrize("S", [33, 70])
def test_mamba_apply_matches_jax(smoke, S):
    jcfg, params, model = smoke
    x = _x(S)
    ref = jmamba.mamba_apply(_layer(params), jnp.asarray(x), jcfg,
                             chunk=jcfg.scan_chunk)
    got = pmamba.mamba_apply(model.layers[0].mixer, torch.as_tensor(x),
                             model.cfg)
    assert got.shape == (2, S, 64) and got.dtype == torch.float32
    close(got, ref)


@pytest.mark.parametrize("cache", ["f32", "bf16"])
def test_mamba_prefill_state_matches_jax(smoke, cache):
    """y, h_S and the pre-conv window against JAX's prefill, whose h_S
    comes from a second scan pass (the port's from the same pass)."""
    jcfg, params, model = smoke
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[cache]
    x = _x(45, seed=4)
    yj, sj = _mamba_prefill(_layer(params, 1), jnp.asarray(x), jcfg, jdt)
    yp, sp = pmamba.mamba_prefill(model.layers[1].mixer, torch.as_tensor(x),
                                  model.cfg, tdt)
    close(yp, yj)
    assert sorted(sp) == sorted(sj)
    assert sp["h"].dtype == torch.float32 and sp["conv"].dtype == tdt
    close(sp["h"], sj["h"])
    close(sp["conv"], np.asarray(sj["conv"].astype(jnp.float32)))


def test_mamba_decode_matches_jax(smoke):
    """Four one-token steps from a prefill state, each state fed back."""
    jcfg, params, model = smoke
    x = _x(37, seed=5)
    p = _layer(params)
    m = model.layers[0].mixer
    _, sj = _mamba_prefill(p, jnp.asarray(x[:, :33]), jcfg, jnp.float32)
    _, sp = pmamba.mamba_prefill(m, torch.as_tensor(x[:, :33]), model.cfg,
                                 torch.float32)
    for t in range(33, 37):
        yj, sj = jmamba.mamba_decode(p, jnp.asarray(x[:, t:t + 1]), jcfg, sj)
        yp, sp = pmamba.mamba_decode(m, torch.as_tensor(x[:, t:t + 1]),
                                     model.cfg, sp)
        close(yp, yj)
        close(sp["h"], sj["h"])
        close(sp["conv"], sj["conv"])


def test_init_mamba_state_matches_jax():
    cfg = PC.get_config(ARCH, smoke=True)
    ref = jmamba.init_mamba_state(JC.get_config(ARCH, smoke=True), 3,
                                  jnp.bfloat16)
    got = pmamba.init_mamba_state(cfg, 3, torch.bfloat16, device="cpu")
    for key in ("h", "conv"):
        assert tuple(got[key].shape) == ref[key].shape
        assert not bool(got[key].any())
    assert got["h"].dtype == torch.float32
    assert got["conv"].dtype == torch.bfloat16


def test_mamba_init_draws_the_reference_distributions():
    cfg = PC.get_config(ARCH, smoke=True)
    m = pmamba.mamba_init(pmamba.Mamba(cfg, device="cpu",
                                       dtype=torch.float32),
                          torch.Generator().manual_seed(0))
    N = cfg.ssm_state
    assert torch.equal(m.A_log, torch.log(torch.arange(
        1, N + 1, dtype=torch.float32)).expand_as(m.A_log))
    assert torch.equal(m.D, torch.ones_like(m.D))
    assert not bool(m.conv_b.any())
    dt = torch.nn.functional.softplus(m.dt_b.detach())
    assert float(dt.min()) >= 1e-3 * 0.999 and float(dt.max()) <= 0.1 * 1.001
    for p in (m.in_proj, m.x_proj, m.out_proj):
        assert float(p.abs().max()) <= 2.0 / p.shape[0] ** 0.5 + 1e-6
    for p in (m.A_log, m.D, m.dt_b, m.conv_w, m.conv_b):
        assert p.dtype == torch.float32


# ---- the model ---------------------------------------------------------------
def test_prefill_runs_one_scan_call_a_chunk(smoke, monkeypatch):
    """A prefill of S = 70 at ``scan_chunk`` 32 scans 3 chunks in each of
    the 2 layers: 6 calls of the kernel op, one pass per layer."""
    _, _, model = smoke
    calls = []
    real = pscan.linear_scan_op
    monkeypatch.setattr(pscan, "linear_scan_op",
                        lambda a, b, **kw: calls.append(a.shape)
                        or real(a, b, **kw))
    toks = np.random.default_rng(6).integers(0, 512, (2, 70))
    PM.prefill(model, {"tokens": toks}, max_len=80)
    di, N = 2 * 64, model.cfg.ssm_state
    assert calls == [(2, 32, di * N)] * 6


@pytest.mark.parametrize("S", [1, 2])
def test_mamba_decode_after_a_short_prompt(S):
    """A prompt shorter than the conv window (S < conv − 1) keeps a window
    left-padded with zeros: prefill and the decode steps after it agree
    with the port's cache-free forward.  (The JAX package's prefill takes
    ``xb[:, -(conv − 1):]``, too short here, and its decode fails.)"""
    model = PM.init_params(PC.get_config(ARCH, smoke=True),
                           torch.Generator().manual_seed(0), device="cpu")
    assert S < model.cfg.ssm_conv - 1
    toks = np.random.default_rng(11).integers(
        0, model.cfg.vocab, (2, S + 6)).astype(np.int32)
    full = model(toks)
    lp, st = PM.prefill(model, {"tokens": toks[:, :S]}, max_len=32,
                        cache_dtype=torch.float32)
    assert st["layers"][0]["conv"].shape == (2, model.cfg.ssm_conv - 1,
                                             2 * model.cfg.d_model)
    torch.testing.assert_close(lp, full[:, S - 1], **TOL)
    for t in range(S, toks.shape[1]):
        lp, st = PM.decode_step(model, toks[:, t:t + 1], st)
        torch.testing.assert_close(lp, full[:, t], **TOL)
    assert st["pos"] == toks.shape[1]


def test_init_decode_state_carries_mamba_states():
    cfg = PC.get_config(ARCH, smoke=True)
    st = PM.init_decode_state(cfg, 2, 64, device="cpu")
    assert st["pos"] == 0 and len(st["layers"]) == cfg.n_layers
    for c in st["layers"]:
        assert sorted(c) == ["conv", "h"]
        assert c["h"].shape == (2, 2 * cfg.d_model, cfg.ssm_state)


def test_full_falcon_mamba_shapes():
    """The full-width model on the meta device: 64 Mamba blocks with no
    MLP, and the matrices ``param_count`` counts."""
    cfg = PC.get_config(ARCH)
    model = Transformer(cfg, device="meta")
    assert len(model.layers) == 64
    blk = model.layers[0]
    assert blk.kind == "mamba" and blk.mlp is None and blk.norm2 is None
    m = blk.mixer
    assert m.in_proj.shape == (4096, 16384) and m.in_proj.dtype == torch.bfloat16
    assert m.x_proj.shape == (8192, 256 + 32) and m.A_log.shape == (8192, 16)
    assert m.A_log.dtype == m.D.dtype == m.conv_w.dtype == torch.float32
    counted = sum(p.numel() for n, p in model.named_parameters()
                  if p.ndim == 2 and "conv_w" not in n)
    assert counted == cfg.param_count()
