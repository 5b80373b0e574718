"""Port vs JAX: the Mixture-of-Experts layer.

JAX's ``moe_init(PRNGKey(0))`` goes into the port's ``MoE`` leaf by
leaf; both packages then route and dispatch the same numpy inputs (a
seed, (2, 64, d) unless said).  Capacity drops make dispatch's output
depend on every discrete decision — the top-k order of ties, the GShard
slot order, the one-hot past capacity, the padded last group — so the
outputs are held to JAX's at 1e-5 over group sizes, capacity factors,
chunkings and a padded group whose zero rows tie.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.models import moe as JMoE
import repro_torch.configs as PC
from repro_torch.models import moe as PMoE

ARCHS = ["qwen2-moe-a2.7b", "dbrx-132b"]


def port_moe(cfg, p, dtype=torch.float32):
    """The port's MoE holding the numbers of JAX's parameter dict ``p``
    (the router stays f32, the rest in ``dtype``)."""
    m = PMoE.MoE(cfg, device="cpu", dtype=dtype).requires_grad_(False)
    with torch.no_grad():
        for name in ("router", "expert_gate", "expert_up", "expert_down"):
            getattr(m, name).copy_(torch.tensor(np.asarray(p[name])))
        assert (m.shared is None) == ("shared" not in p)
        for name, arr in p.get("shared", {}).items():
            getattr(m.shared, name).copy_(torch.tensor(np.asarray(arr)))
    return m


def setup(arch, S=64, **over):
    """(JAX cfg, port cfg, JAX params, the port's MoE, x (2, S, d))."""
    jcfg = jax_config(arch, smoke=True).replace(**over)
    pcfg = PC.get_config(arch, smoke=True).replace(**over)
    p = JMoE.moe_init(jax.random.PRNGKey(0), jcfg)
    x = np.random.default_rng(1).standard_normal(
        (2, S, jcfg.d_model)).astype(np.float32)
    return jcfg, pcfg, p, port_moe(pcfg, p), x


def dispatch_pair(arch, group, S=64, **over):
    jcfg, pcfg, p, m, x = setup(arch, S, **over)
    oj, aj = JMoE.moe_dispatch(p, jnp.asarray(x), jcfg, group_size=group)
    op, ap = PMoE.moe_dispatch(m, torch.tensor(x), pcfg, group_size=group)
    return (oj, aj), (op, ap)


def close(port, ref, atol):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(ref, dtype=np.float32), atol=atol,
                               rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_router_matches_jax(arch):
    jcfg, pcfg, p, m, x = setup(arch)
    xf = x.reshape(-1, jcfg.d_model)
    pj, ij, aj = JMoE._router(p, jnp.asarray(xf), jcfg)
    pp, ip, ap = PMoE._router(m, torch.tensor(xf), pcfg)
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    close(pp, pj, 1e-6)
    for key in ("moe_lb", "moe_z"):
        assert abs(float(ap[key]) - float(aj[key])) <= 1e-6 * max(
            1.0, abs(float(aj[key])))


@pytest.mark.parametrize("arch", ARCHS)
def test_equal_probabilities_pick_the_lowest_experts(arch):
    """Zero rows (the padding of a last group) have exactly uniform
    probabilities: top-k takes experts 0 … k−1, as ``jax.lax.top_k``
    does.  ``torch.topk`` promises no order among ties (torch 2.13's CPU
    kernel returned [39, 40, 41, 38] on a row of 60 equal values)."""
    jcfg, pcfg, p, m, x = setup(arch)
    xf = x.reshape(-1, jcfg.d_model)[:6].copy()
    xf[1::2] = 0.0
    _, ij, _ = JMoE._router(p, jnp.asarray(xf), jcfg)
    _, ip, _ = PMoE._router(m, torch.tensor(xf), pcfg)
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    lowest = np.arange(jcfg.top_k)
    for row in ip[1::2].numpy():
        np.testing.assert_array_equal(row, lowest)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_matches_jax(arch):
    jcfg, pcfg, p, m, x = setup(arch)
    oj, aj = JMoE.moe_dense(p, jnp.asarray(x), jcfg)
    op, ap = PMoE.moe_dense(m, torch.tensor(x), pcfg)
    close(op, oj, 1e-5)
    assert abs(float(ap["moe_lb"]) - float(aj["moe_lb"])) <= 1e-6


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("group", [16, 32, 64, 128])
def test_dispatch_matches_jax_at_group_sizes(arch, group):
    (oj, aj), (op, ap) = dispatch_pair(arch, group)
    close(op, oj, 1e-5)
    assert abs(float(ap["moe_z"]) - float(aj["moe_z"])) <= 1e-6 * max(
        1.0, float(aj["moe_z"]))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("factor", [0.25, 1.25, 8.0])
def test_dispatch_matches_jax_at_capacity_factors(arch, factor):
    """0.25 drops most second choices, 1.25 (the default) some, 8 none."""
    (oj, _), (op, _) = dispatch_pair(arch, 32, capacity_factor=factor)
    close(op, oj, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("parallel", [1, 2, 8])
def test_dispatch_matches_jax_at_chunkings(arch, parallel):
    """Eight groups of 16 in chunks of 1, 2 or 8 (JAX's scan over chunks
    against the port's loop), with drops at the default capacity."""
    (oj, _), (op, _) = dispatch_pair(arch, 16, moe_parallel_groups=parallel)
    close(op, oj, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_matches_jax_with_a_padded_group(arch):
    """N = 66 in groups of 64: the second group holds 2 tokens and 62
    zero rows, whose tied first choices claim slots of experts 0 … k−1
    before the real tokens' second choices, at a capacity that drops."""
    C = PMoE.capacity(PC.get_config(arch, smoke=True), 64)
    assert C < 62 + 2
    (oj, _), (op, _) = dispatch_pair(arch, 64, S=33)
    close(op, oj, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_equals_dense_at_high_capacity(arch):
    """The port's own two paths: at capacity factor 8 nothing is dropped,
    so dispatch is the dense oracle."""
    _, pcfg, _, m, x = setup(arch, capacity_factor=8.0)
    for group in (16, 128):
        od, _ = PMoE.moe_dense(m, torch.tensor(x), pcfg)
        og, _ = PMoE.moe_dispatch(m, torch.tensor(x), pcfg, group_size=group)
        torch.testing.assert_close(og, od, atol=1e-5, rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_slot_positions_follow_gshard_order(arch):
    """All first choices take slots before any second choice, each in
    token order."""
    pcfg = PC.get_config(arch, smoke=True)
    E = pcfg.n_experts
    ii = torch.tensor([[[0, 1], [0, 2], [1, 0]]])    # (1 group, 3, k=2)
    _, pos = PMoE.slot_positions(ii, E)
    # expert 0: tokens 0 and 1 (1st choices), then token 2 (2nd);
    # expert 1: token 2 (1st), then token 0 (2nd); expert 2: token 1 (2nd)
    np.testing.assert_array_equal(pos[0].numpy(),
                                  [[0, 1], [1, 0], [0, 2]])


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_dispatch_matches_jax(arch):
    """In bf16 the routes are the same (the router runs in f32 on the
    same bf16 inputs) and the outputs agree to one bf16 rounding step of
    the largest output: JAX's CPU backend and PyTorch round the bf16
    intermediates (the gate's activation, the products) at other places,
    which moves most outputs by about one bf16 ulp, so the serving
    test's atol 2e-4 / rtol 1e-3 is out of reach in bf16."""
    jcfg, pcfg, p, _, x = setup(arch)
    m = port_moe(pcfg, p, torch.bfloat16)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.tensor(x).bfloat16()
    _, ij, _ = JMoE._router(p, jx.reshape(-1, jcfg.d_model), jcfg)
    _, ip, _ = PMoE._router(m, tx.reshape(-1, pcfg.d_model), pcfg)
    np.testing.assert_array_equal(ip.numpy(), np.asarray(ij))
    oj, _ = JMoE.moe_dispatch(p, jx, jcfg, group_size=64)
    op, _ = PMoE.moe_dispatch(m, tx, pcfg, group_size=64)
    assert op.dtype == torch.bfloat16
    ref = np.asarray(oj.astype(jnp.float32))
    step = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    close(op, ref, step)
