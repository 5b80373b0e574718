"""Mixture-of-Experts layer — GShard/Switch-style grouped dispatch.

Two execution paths share the same parameters, as in the JAX package:

``moe_dispatch`` (default)
    Capacity-based one-hot dispatch/combine products over token groups.
    Tokens beyond an expert's capacity are dropped (the residual passes
    through, as in Switch).  Groups are independent; they run in chunks
    of ``cfg.moe_parallel_groups``, so peak memory is one chunk's
    (m, G, E, C) dispatch tensors and expert activations.

``moe_dense`` (oracle)
    Every expert on every token, exact top-k combine, no capacity drops.

Routing: softmax → top-k, probabilities renormalised over the selected
experts; ties go to the lower expert index, as ``jax.lax.top_k`` breaks
them (``torch.topk`` does not promise an order).  Aux losses: Switch
load-balance loss and router z-loss.  The router is kept and applied in
f32 whatever the compute dtype.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..distributed.sharding import constrain
from .common import dense_init, trunc_normal
from .mlp import MLP, _act, mlp, mlp_init

__all__ = ["MoE", "moe_init", "moe_apply", "moe_dense", "moe_dispatch",
           "capacity", "slot_positions"]


class MoE(nn.Module):
    """router (d, E) in f32; expert_gate, expert_up (E, d, f) and
    expert_down (E, f, d) in the compute dtype; ``shared``, an MLP of
    width f · n_shared_experts, when the config has shared experts."""

    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
        kw = dict(device=device, dtype=dtype)
        self.router = nn.Parameter(torch.empty(d, E, device=device,
                                               dtype=torch.float32))
        self.expert_gate = nn.Parameter(torch.empty(E, d, f, **kw))
        self.expert_up = nn.Parameter(torch.empty(E, d, f, **kw))
        self.expert_down = nn.Parameter(torch.empty(E, f, d, **kw))
        self.shared = (MLP(d, f * cfg.n_shared_experts, device, dtype)
                       if cfg.n_shared_experts else None)


def moe_init(m: MoE, cfg, generator) -> MoE:
    d, f = cfg.d_model, cfg.d_ff_expert
    dense_init(m.router, d, generator, std=0.02)
    trunc_normal(m.expert_gate, 1.0 / math.sqrt(d), generator)
    trunc_normal(m.expert_up, 1.0 / math.sqrt(d), generator)
    trunc_normal(m.expert_down, 1.0 / math.sqrt(f), generator)
    if m.shared is not None:
        mlp_init(m.shared, generator)
    return m


def _router(m: MoE, x, cfg):
    """x: (N, d) → top-k probs (N, k) f32, indices (N, k), aux losses."""
    logits = x.float() @ m.router.float()
    probs = torch.softmax(logits, dim=-1)
    # a stable descending sort puts equal probabilities in index order
    top_p, top_i = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_i = top_p[:, :cfg.top_k], top_i[:, :cfg.top_k]
    top_p = top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9)
    # Switch load-balance loss: E · Σ_e f_e · P_e
    E = cfg.n_experts
    # the count of each expert's choices as a sum of ones (exact below
    # 2²⁴, as bincount's), which also runs on the meta device
    idx = top_i.reshape(-1)
    occupancy = torch.zeros(E, dtype=torch.float32, device=x.device)
    occupancy.index_add_(0, idx, torch.ones_like(idx, dtype=torch.float32))
    f_e = occupancy / torch.clamp_min(occupancy.sum(), 1.0)
    P_e = probs.mean(dim=0)
    lb_loss = E * torch.sum(f_e * P_e)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)
    return top_p, top_i, {"moe_lb": lb_loss, "moe_z": z_loss}


def _expert_ffn(m: MoE, h, cfg):
    """h: (..., E, C, d) → each expert's gated MLP on its C rows, as one
    batched product per weight with the expert axis as the batch."""
    E, C, d = h.shape[-3:]
    lead = h.shape[:-3]
    dt = h.dtype
    he = h.movedim(-3, 0).reshape(E, -1, d)
    g = torch.bmm(he, m.expert_gate.to(dt))
    u = torch.bmm(he, m.expert_up.to(dt))
    a = constrain(_act(g, cfg.mlp) * u, "expert", None, "ff")
    o = torch.bmm(a, m.expert_down.to(dt))
    return o.reshape(E, *lead, C, d).movedim(0, -3)


def capacity(cfg, G: int) -> int:
    """Slots per expert and group: ⌈G·k/E·capacity_factor⌉ rounded up to
    a multiple of 8."""
    C = math.ceil(G * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return -(-C // 8) * 8


def slot_positions(ii, E: int):
    """GShard slot order within each group: all first choices claim an
    expert's slots before any second choice, in token order.  ii: (m, G,
    k) expert indices → (one-hot (m, G, k, E) f32, slot (m, G, k) f32).
    The counts are sums of 0/1 in f32, exact below 2²⁴ as in JAX."""
    oh = torch.nn.functional.one_hot(ii, E).float()      # (m, G, k, E)
    base = torch.zeros_like(oh[:, :1, 0])                # (m, 1, E)
    pos = []
    for j in range(ii.shape[-1]):
        o = oh[:, :, j]
        pos_e = torch.cumsum(o, dim=1) - o + base
        pos.append((pos_e * o).sum(-1))
        base = base + o.sum(dim=1, keepdim=True)
    return oh, torch.stack(pos, dim=-1)


def _chunk_fwd(m: MoE, xg, ii, pi, cfg, C):
    """A chunk of groups: xg (m, G, d), ii/pi (m, G, k) → (m, G, d)."""
    mg, G, d = xg.shape
    E = cfg.n_experts
    oh, pos = slot_positions(ii, E)
    # one-hot of the slot, zero past capacity (jax.nn.one_hot's rows for
    # an index ≥ C), by comparison: F.one_hot raises there
    poh = (pos[..., None] == torch.arange(C, device=xg.device)).float()
    dispatch = torch.zeros((mg, G, E, C), dtype=torch.float32,
                           device=xg.device)
    combine = torch.zeros_like(dispatch)
    for j in range(ii.shape[-1]):
        pair = oh[:, :, j, :, None] * poh[:, :, j, None, :]
        dispatch += pair
        combine += pair * pi[:, :, j, None, None]
    dt = xg.dtype
    dispatch = constrain(dispatch.to(dt), "batch", None, "expert", None)
    dispatch = dispatch.reshape(mg, G, E * C)
    combine = combine.to(dt).reshape(mg, G, E * C)
    hc = torch.bmm(dispatch.transpose(1, 2), xg).reshape(mg, E, C, d)
    hc = constrain(hc, "batch", "expert", None, None)
    out_e = _expert_ffn(m, hc, cfg).reshape(mg, E * C, d)
    return torch.bmm(combine, out_e)


def moe_dispatch(m: MoE, x, cfg, group_size: int = 1024):
    """Capacity-based grouped dispatch. x: (B, S, d) → (out, aux).

    N = B·S tokens in groups of G = min(group_size, N), the last padded
    with zero rows (which route, tie, and claim slots as real tokens
    do); C slots per expert and group (``capacity``).  The groups run
    ``cfg.moe_parallel_groups`` at a time (the JAX package's scan over
    chunks pads whole groups of zeros to fill the last chunk; groups are
    independent, so running the last chunk short gives the same rows)."""
    B, S, d = x.shape
    N = B * S
    xf = x.reshape(N, d)
    G = min(group_size, N)
    n = -(-N // G)
    pad = n * G - N
    if pad:
        xf = torch.nn.functional.pad(xf, (0, 0, 0, pad))
    top_p, top_i, aux = _router(m, xf, cfg)
    C = capacity(cfg, G)
    xg = xf.reshape(n, G, d)
    pi = top_p.reshape(n, G, -1)
    ii = top_i.reshape(n, G, -1)
    mg = min(n, cfg.moe_parallel_groups)
    out = torch.cat([_chunk_fwd(m, xg[s:s + mg], ii[s:s + mg],
                                pi[s:s + mg], cfg, C)
                     for s in range(0, n, mg)])
    out = out.reshape(-1, d)[:N].reshape(B, S, d)
    if m.shared is not None:
        out = out + mlp(m.shared, x, cfg.mlp)
    return out, aux


def moe_dense(m: MoE, x, cfg):
    """Oracle: every expert on every token, exact combine."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    N, E = xf.shape[0], cfg.n_experts
    top_p, top_i, aux = _router(m, xf, cfg)
    h = xf[:, None, None, :].expand(N, E, 1, d)
    out_e = _expert_ffn(m, h, cfg)[:, :, 0]               # (N, E, d)
    gates = torch.zeros((N, E), dtype=torch.float32, device=x.device)
    gates.scatter_add_(1, top_i, top_p)
    out = torch.einsum("ne,ned->nd", gates.to(out_e.dtype), out_e)
    out = out.reshape(B, S, d)
    if m.shared is not None:
        out = out + mlp(m.shared, x, cfg.mlp)
    return out, aux


def moe_apply(m: MoE, x, cfg):
    if cfg.moe_impl == "dense":
        return moe_dense(m, x, cfg)
    return moe_dispatch(m, x, cfg, group_size=cfg.moe_group_size)
