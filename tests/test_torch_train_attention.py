"""Port vs JAX: the gradients of attention and of the cross-entropy.

Attention: autograd through the plain version (``attention_ref``, which
the card's backward kernel is held against in ``chip_smoke.py``) against
``jax.grad`` of ``flash_attention_xla`` (the JAX package's training
attention) on the shapes of ``chip_smoke.K5_OPTIONS`` cut to CPU size:
softcap, GQA, MHA, cross lengths, a window, hd 33, rows with no unmasked
key.  f32 inputs from a seeded numpy generator; dq, dk, dv to atol 1e-5
· (the gradient's largest |value|), rtol 1e-4.

Cross-entropy: ``chunked_cross_entropy`` against the port's
``cross_entropy`` on full logits and against the JAX package's, with a
chunk that does not divide S, labels of −1 and a final softcap; values
and gradients (h, table) in f32 to rtol 1e-5.

Dispatch: on CPU tensors the ops take their plain versions with
autograd; on CUDA inputs that require a gradient ``linear_scan_op`` goes
through ``LinearScan`` (K4 and its backward), never the plain scan.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as JC
from repro.models.attention import flash_attention_xla
from repro.models.common import chunked_cross_entropy as j_chunked_ce
import repro_torch.configs as PC
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import kernel as FK
from repro_torch.kernels.flash_attention import ops as FO
from repro_torch.kernels.linear_scan import kernel as SK
from repro_torch.kernels.linear_scan import ops as SO
from repro_torch.kernels.linear_scan.ref import linear_scan_bwd_ref
from repro_torch.models.common import chunked_cross_entropy, cross_entropy

# (B, S, T, H, K, hd), causal, window, cap
CASES = {
    "gemma2_local_cap50": ((1, 96, 96, 4, 2, 32), True, 40, 50.0),
    "gemma2_global_cap50": ((1, 96, 96, 4, 2, 32), True, None, 50.0),
    "llama_gqa4_hd64": ((2, 77, 77, 8, 2, 64), True, None, None),
    "mha": ((1, 50, 50, 4, 4, 16), True, None, None),
    "cross_unmasked": ((1, 30, 17, 4, 2, 16), False, None, None),
    "hd96_window": ((1, 40, 40, 4, 1, 96), True, 16, None),
    "hd33_window": ((1, 43, 43, 4, 2, 33), True, 10, None),
    "no_key_rows_window": ((1, 40, 17, 4, 2, 16), False, 8, None),
    "no_key_rows_causal": ((1, 60, 25, 2, 1, 16), True, 8, None),
}


def qkvo(shape, seed=0):
    B, S, T, H, K, hd = shape
    rng = np.random.default_rng(seed)
    q = (0.5 * rng.standard_normal((B, S, H, hd))).astype(np.float32)
    k = rng.standard_normal((B, T, K, hd)).astype(np.float32)
    v = rng.standard_normal((B, T, K, hd)).astype(np.float32)
    do = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    return q, k, v, do


@pytest.mark.parametrize("name", CASES)
def test_plain_attention_grads_match_jax(name):
    shape, causal, window, cap = CASES[name]
    q, k, v, do = qkvo(shape)
    kw = dict(causal=causal, window=window, cap=cap)

    def f(q_, k_, v_):
        return jnp.sum(flash_attention_xla(q_, k_, v_, q_block=32,
                                           kv_block=32, **kw) * do)

    jg = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(q, k, v)
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = FO.flash_attention_op(qt, kt, vt, **kw)
    out.backward(torch.tensor(do))
    for got, ref, nm in zip((qt.grad, kt.grad, vt.grad), jg, "qkv"):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * np.abs(ref).max(),
                                   err_msg=f"d{nm}")
    assert FK.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0}


def test_key_less_rows_take_the_uniform_softmax_and_no_score_gradient():
    """The behaviour the backward kernel copies: a row with no unmasked key
    spreads dO evenly over all T keys in dV and gives dQ nothing."""
    shape, causal, window, cap = CASES["no_key_rows_causal"]
    q, k, v, do = qkvo(shape)
    T = shape[2]
    qt, kt, vt = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = FO.attention_ref(qt, kt, vt, causal=causal, window=window, cap=cap)
    out.backward(torch.tensor(do))
    rows = np.arange(shape[1]) >= T + window - 1
    assert rows.any()
    np.testing.assert_array_equal(qt.grad.numpy()[:, rows], 0.0)
    # H = 2 query heads read the one kv head: each gets mean_t v
    want = np.broadcast_to(v.mean(1)[:, None, [0, 0]], out[:, rows].shape)
    np.testing.assert_allclose(out.detach().numpy()[:, rows], want,
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("S,chunk,cap", [(33, 8, None), (40, 40, 30.0),
                                         (17, 512, None), (33, 5, 30.0)])
def test_chunked_cross_entropy_matches_plain_and_jax(S, chunk, cap):
    rng = np.random.default_rng(S + chunk)
    Bn, d, V = 2, 16, 50
    h = rng.standard_normal((Bn, S, d)).astype(np.float32)
    table = (0.3 * rng.standard_normal((V, d))).astype(np.float32)
    labels = rng.integers(0, V, (Bn, S)).astype(np.int32)
    labels[0, ::3] = -1
    cfg = PC.get_config("llama3.2-1b", smoke=True).replace(final_softcap=cap)
    jcfg = JC.get_config("llama3.2-1b", smoke=True).replace(
        final_softcap=cap)

    ht, tt = (torch.tensor(x, requires_grad=True) for x in (h, table))
    loss = chunked_cross_entropy(ht, tt, labels, cfg, chunk=chunk)
    gh, gt = torch.autograd.grad(loss, (ht, tt))
    ht2, tt2 = (torch.tensor(x, requires_grad=True) for x in (h, table))
    logits = ht2 @ tt2.T
    if cap is not None:
        logits = cap * torch.tanh(logits / cap)
    plain = cross_entropy(logits, labels)
    ph, pt = torch.autograd.grad(plain, (ht2, tt2))
    jl, (jh, jt) = jax.value_and_grad(
        lambda a, b: j_chunked_ce(a, b, labels, jcfg, chunk=chunk),
        argnums=(0, 1))(h, table)

    np.testing.assert_allclose(float(loss), float(plain), rtol=1e-6)
    np.testing.assert_allclose(float(loss), float(jl), rtol=1e-5)
    for got, ref in ((gh, ph), (gt, pt)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                                   atol=1e-7)
    for got, ref in ((gh, jh), (gt, jt)):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-4,
                                   atol=1e-6)


def test_cross_entropy_ignores_negative_labels_and_masked_positions():
    rng = np.random.default_rng(0)
    logits = torch.tensor(rng.standard_normal((2, 5, 7)).astype(np.float32))
    labels = np.array([[1, -1, 2, 3, -1], [0, 0, 6, -1, 5]])
    mask = np.array([[1, 1, 1, 0, 1], [1, 1, 1, 1, 1]])
    got = float(cross_entropy(logits, labels, mask))
    lp = torch.log_softmax(logits, -1).numpy()
    keep = [(b, s) for b in range(2) for s in range(5)
            if labels[b, s] >= 0 and mask[b, s]]
    want = -np.mean([lp[b, s, labels[b, s]] for b, s in keep])
    np.testing.assert_allclose(got, want, rtol=1e-6)
    none = cross_entropy(logits, -np.ones((2, 5), dtype=np.int64))
    assert float(none) == 0.0


def test_linear_scan_takes_gradients_through_its_function_on_the_card(
        monkeypatch):
    """With the op told the tensors are the card's, an input that needs a
    gradient goes through ``LinearScan`` (K4 forward, K4's backward) and
    never through the plain scan; without a gradient the op calls the
    kernel alone, which refuses CPU tensors."""
    rng = np.random.default_rng(4)
    a = torch.tensor(rng.uniform(0.5, 1.0, (1, 8, 4)), dtype=torch.float32,
                     requires_grad=True)
    b = torch.tensor(rng.standard_normal((1, 8, 4)), dtype=torch.float32)
    g = torch.tensor(rng.standard_normal((1, 8, 4)), dtype=torch.float32)
    ref = SO.linear_scan_ref
    calls = []

    def fwd(a_, b_):
        calls.append("linear_scan")
        return ref(a_, b_)

    def bwd(a_, h_, dh_):
        calls.append("linear_scan_bwd")
        return linear_scan_bwd_ref(a_, h_, dh_)

    def plain(a_, b_):
        raise AssertionError("the op took the plain scan")

    monkeypatch.setattr(SO, "use_cuda_for", lambda x, impl: True)
    monkeypatch.setattr(SO, "linear_scan", fwd)
    monkeypatch.setattr(SO, "linear_scan_bwd", bwd)
    monkeypatch.setattr(SO, "linear_scan_ref", plain)
    h = SO.linear_scan_op(a, b)
    assert h.grad_fn is not None and "LinearScan" in type(h.grad_fn).__name__
    (da,) = torch.autograd.grad(h, a, g)
    assert calls == ["linear_scan", "linear_scan_bwd"]
    a_ref = a.detach().clone().requires_grad_()
    (da_ref,) = torch.autograd.grad(ref(a_ref, b), a_ref, g)
    np.testing.assert_allclose(da.numpy(), da_ref.numpy(), rtol=1e-5,
                               atol=1e-6)
    monkeypatch.setattr(SO, "linear_scan", SK.linear_scan)
    with torch.no_grad():           # serving: no gradient, the kernel
        with pytest.raises(ValueError, match="CUDA tensors"):
            SO.linear_scan_op(a, b)
    assert SK.LAUNCHES == {"linear_scan": 0, "linear_scan_bwd": 0}


def test_linear_scan_plain_version_takes_gradients_on_the_cpu():
    rng = np.random.default_rng(3)
    a = torch.tensor(rng.uniform(0.5, 1.0, (2, 9, 3)), requires_grad=True)
    b = torch.tensor(rng.standard_normal((2, 9, 3)), requires_grad=True)
    h = SO.linear_scan_op(a.float(), b.float())
    g = torch.tensor(rng.standard_normal((2, 9, 3)), dtype=torch.float32)
    h.backward(g)
    # the reverse scan: g_t = ∂h_t + a_{t+1} g_{t+1}; ∂b = g, ∂a = g·h_{t−1}
    an, hn, gn = a.detach().numpy(), h.detach().double().numpy(), g.numpy()
    acc = np.zeros((2, 3))
    gb = np.zeros_like(an)
    for t in range(8, -1, -1):
        acc = gn[:, t] + (an[:, t + 1] * acc if t < 8 else 0.0)
        gb[:, t] = acc
    ga = gb * np.concatenate([np.zeros((2, 1, 3)), hn[:, :-1]], 1)
    np.testing.assert_allclose(b.grad.numpy(), gb, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(a.grad.numpy(), ga, rtol=1e-5, atol=1e-6)


def test_flash_attention_backward_wrapper_refuses_cpu_tensors():
    q, k, v, do = (torch.tensor(x) for x in qkvo((1, 8, 8, 2, 1, 16)))
    lse = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        FK.flash_attention_bwd(q, k, v, do, lse)
    assert "flash_attention_bwd" in _build.SOURCES
    assert FK.LAUNCHES == {"flash_attention": 0, "flash_attention_bwd": 0}
