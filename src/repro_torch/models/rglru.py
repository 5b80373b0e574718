"""RG-LRU recurrent block (RecurrentGemma / Griffin).

Per block: the residual stream feeds a *recurrent branch* —
  linear d → w (x), linear d → w (gate z)
  conv1d (temporal, width 4) on x
  RG-LRU:  r_t = σ(Wa·x_t),  i_t = σ(Wx·x_t)
           a_t = exp(−c · softplus(Λ) · r_t)
           h_t = a_t ⊙ h_{t−1} + √(1 − a_t²) ⊙ (i_t ⊙ x_t)
  out = (h ⊙ gelu(z)) @ W_out
with c = 8.  The full-sequence recurrence goes through the linear scan op
(``kernels/linear_scan``: the CUDA kernel on the card, its plain version
on the CPU), once per layer: the same call gives every h_t and the decode
state h_S.  Decode carries (h, conv window).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import constrain
from ..kernels.linear_scan.ops import linear_scan_op
from .common import causal_conv, dense_init

__all__ = ["RGLRU", "rglru_init", "gates", "causal_conv", "rglru_apply",
           "rglru_prefill", "init_rglru_state", "rglru_decode"]

_C = 8.0


class RGLRU(nn.Module):
    """in_x, in_z (d, w); conv_w (conv, w), conv_b (w); gate_a, gate_i
    (w, w); lam (w) in f32; out (w, d)."""

    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        d = cfg.d_model
        w = cfg.lru_width or d
        kw = dict(device=device, dtype=dtype)
        self.in_x = nn.Parameter(torch.empty(d, w, **kw))
        self.in_z = nn.Parameter(torch.empty(d, w, **kw))
        self.conv_w = nn.Parameter(torch.empty(cfg.ssm_conv, w, **kw))
        self.conv_b = nn.Parameter(torch.zeros(w, **kw))
        self.gate_a = nn.Parameter(torch.empty(w, w, **kw))
        self.gate_i = nn.Parameter(torch.empty(w, w, **kw))
        self.lam = nn.Parameter(torch.empty(w, dtype=torch.float32,
                                            device=device))
        self.out = nn.Parameter(torch.empty(w, d, **kw))


def rglru_init(m: RGLRU, generator) -> RGLRU:
    d, w = m.in_x.shape
    # Λ so that a^c ∈ (0.9, 0.999) roughly (Griffin appendix)
    u = torch.empty(w, dtype=torch.float32, device=m.lam.device)
    u.uniform_(0.9, 0.999, generator=generator)
    with torch.no_grad():
        m.lam.copy_(torch.log(torch.exp(-torch.log(u) / _C) - 1.0 + 1e-8))
        x = torch.empty(m.conv_w.shape, dtype=torch.float32,
                        device=m.conv_w.device)
        x.normal_(generator=generator)
        m.conv_w.copy_(0.1 * x)
    dense_init(m.in_x, d, generator)
    dense_init(m.in_z, d, generator)
    dense_init(m.gate_a, w, generator)
    dense_init(m.gate_i, w, generator)
    dense_init(m.out, w, generator)
    return m


def gates(m: RGLRU, xc):
    """(a, β·i) in f32: the matmuls and sigmoids in xc's dtype, then f32."""
    r = torch.sigmoid(xc @ m.gate_a.to(xc.dtype)).float()
    i = torch.sigmoid(xc @ m.gate_i.to(xc.dtype)).float()
    log_a = -_C * torch.logaddexp(m.lam, torch.zeros_like(m.lam)) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return a, beta * i


def _scan(m: RGLRU, x):
    """Every h_t (f32) of the recurrence over the sequence, and z and the
    pre-conv xb."""
    xb = constrain(x @ m.in_x, "batch", None, "ff")
    z = x @ m.in_z
    xc, _ = causal_conv(m, xb)
    xc = constrain(xc, "batch", None, "ff")
    a, bi = gates(m, xc)
    b = (bi * xc.float()).contiguous()
    h = linear_scan_op(a.contiguous(), b)
    return h, z, xb


def rglru_apply(m: RGLRU, x, cfg):
    """Full-sequence RG-LRU branch. x: (B, S, d) → (B, S, d)."""
    return rglru_prefill(m, x, cfg)[0]


def rglru_prefill(m: RGLRU, x, cfg, cache_dtype=torch.bfloat16):
    """``rglru_apply`` and the decode state after S tokens, from one scan:
    h_S is the scan's last step (f32) and the conv window holds the last
    conv−1 *pre-conv* inputs, in ``cache_dtype``.  A prompt shorter than
    the window leaves zero rows in front of it: the zeros the cache-free
    forward's causal conv sees before the first token."""
    h, z, xb = _scan(m, x)
    y = constrain(h.to(x.dtype) * F.gelu(z, approximate="tanh"), "batch",
                  None, "ff")
    y = constrain(y @ m.out, "batch", None, None)
    K = m.conv_w.shape[0]
    S = xb.shape[1]
    tail = xb[:, max(S - (K - 1), 0):]
    tail = F.pad(tail, (0, 0, K - 1 - tail.shape[1], 0))
    state = {"h": h[:, -1].clone(), "conv": tail.to(cache_dtype)}
    return y, state


def init_rglru_state(cfg, B, dtype=torch.float32, device=None):
    w = cfg.lru_width or cfg.d_model
    return {"h": torch.zeros((B, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((B, cfg.ssm_conv - 1, w), dtype=dtype,
                                device=device)}


def rglru_decode(m: RGLRU, x, cfg, state):
    """One token: x (B, 1, d) → (y (B, 1, d), new state)."""
    xb = x @ m.in_x
    z = x @ m.in_z
    xb, conv_tail = causal_conv(m, xb, init=state["conv"])
    a, bi = gates(m, xb[:, 0])
    h = a * state["h"] + bi * xb[:, 0].float()
    y = h.to(x.dtype)[:, None] * F.gelu(z, approximate="tanh")
    return y @ m.out, {"h": h, "conv": conv_tail}
