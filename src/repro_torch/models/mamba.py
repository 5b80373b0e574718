"""Mamba-1 block (falcon-mamba-7b) — selective SSM, attention-free.

Structure per block (d = d_model, di = expand·d, N = ssm_state):
  in_proj  d → 2·di  (x, z branches)
  conv1d   depthwise causal, width conv, over the x branch
  x_proj   di → dt_rank + 2N   (Δ low-rank, B, C)
  dt_proj  dt_rank → di        (Δ broadcast, softplus)
  SSM      h_t = exp(Δ_t A) h_{t−1} + Δ_t B_t x_t ;  y = C_t·h + D·x
  gate     y · silu(z);  out_proj di → d

Falcon-Mamba also RMS-norms (Δ, B, C) before discretization
(``ssm_rms_bcdt``).  The sequence path runs the recurrence chunk by
chunk through the linear scan kernel (``scan_ops.chunked_linear_scan``:
the (B, c, di, N) a and b exist one chunk at a time); prefill takes the
decode state h_S from the same pass.  Decode updates (conv window, h)
one token at a time.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import constrain
from .common import causal_conv, dense_init
from .scan_ops import chunked_linear_scan

__all__ = ["Mamba", "mamba_init", "mamba_apply", "mamba_prefill",
           "init_mamba_state", "mamba_decode"]


class Mamba(nn.Module):
    """in_proj (d, 2·di), x_proj (di, R + 2N), dt_w (R, di), out_proj
    (di, d) in the compute dtype; conv_w (conv, di), conv_b, dt_b, D (di)
    and A_log (di, N) in f32."""

    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        d = cfg.d_model
        di = cfg.ssm_expand * d
        N, R = cfg.ssm_state, cfg.dt_rank
        kw = dict(device=device, dtype=dtype)
        f32 = dict(device=device, dtype=torch.float32)
        self.in_proj = nn.Parameter(torch.empty(d, 2 * di, **kw))
        self.conv_w = nn.Parameter(torch.empty(cfg.ssm_conv, di, **f32))
        self.conv_b = nn.Parameter(torch.zeros(di, **f32))
        self.x_proj = nn.Parameter(torch.empty(di, R + 2 * N, **kw))
        self.dt_w = nn.Parameter(torch.empty(R, di, **kw))
        self.dt_b = nn.Parameter(torch.empty(di, **f32))
        self.A_log = nn.Parameter(torch.empty(di, N, **f32))
        self.D = nn.Parameter(torch.ones(di, **f32))
        self.out_proj = nn.Parameter(torch.empty(di, d, **kw))


def mamba_init(m: Mamba, generator) -> Mamba:
    """The JAX package's initialisers from ``generator``: A = 1..N per
    channel, Δ's bias the softplus inverse of exp(U(ln 1e-3, ln 1e-1)),
    D = 1, projections truncated normal 1/√d_in, dt_w normal
    dt_rank^−½, conv_w 0.1·N(0, 1)."""
    d, di = m.in_proj.shape[0], m.in_proj.shape[1] // 2
    R, N = m.dt_w.shape[0], m.A_log.shape[1]
    dev = m.A_log.device

    def normal(shape):
        x = torch.empty(shape, dtype=torch.float32, device=dev)
        return x.normal_(generator=generator)

    u = torch.empty(di, dtype=torch.float32, device=dev)
    u.uniform_(math.log(1e-3), math.log(1e-1), generator=generator)
    with torch.no_grad():
        m.conv_w.copy_(0.1 * normal(m.conv_w.shape))
        m.conv_b.zero_()
        m.dt_w.copy_(R ** -0.5 * normal(m.dt_w.shape))
        m.dt_b.copy_(torch.log(torch.exp(torch.exp(u)) - 1.0 + 1e-9))
        m.A_log.copy_(torch.log(torch.arange(
            1, N + 1, dtype=torch.float32, device=dev)).expand(di, N))
        m.D.fill_(1.0)
    dense_init(m.in_proj, d, generator)
    dense_init(m.x_proj, di, generator)
    dense_init(m.out_proj, di, generator)
    return m


def _rms(t):
    t32 = t.float()
    return (t32 * torch.rsqrt(t32.pow(2).mean(-1, keepdim=True) + 1e-6)
            ).to(t.dtype)


def _split_xdbc(m: Mamba, xc, cfg):
    """x_proj + dt_proj on the conv-activated xc (B, c, di): Δ (B, c, di)
    after softplus, B and C (B, c, N), all in xc's dtype, with the f32 RMS
    on (Δ, B, C) first when ``cfg.ssm_rms_bcdt``."""
    N, R = cfg.ssm_state, cfg.dt_rank
    dbc = xc @ m.x_proj.to(xc.dtype)
    dt_r, Bm, Cm = torch.split(dbc, [R, N, N], dim=-1)
    if cfg.ssm_rms_bcdt:
        dt_r, Bm, Cm = _rms(dt_r), _rms(Bm), _rms(Cm)
    dt = F.softplus(dt_r @ m.dt_w.to(xc.dtype) + m.dt_b.to(xc.dtype))
    return dt, Bm, Cm


def _discretize(dt, xc, Bm, A):
    """(a, b) of the recurrence, (B, c, di, N) in f32."""
    dtf = dt.float()
    a = torch.exp(dtf[..., None] * A)
    b = (dtf * xc.float())[..., None] * Bm.float()[..., None, :]
    return a, b


def _readout(m: Mamba, h, Cm, xc):
    """y = C·h + D·x in f32, returned in xc's dtype."""
    y = torch.einsum("bcdn,bcn->bcd", h, Cm.float())
    return (y + m.D * xc.float()).to(xc.dtype)


def mamba_apply(m: Mamba, x, cfg, chunk=None):
    """Full-sequence Mamba. x: (B, S, d) → (B, S, d)."""
    return mamba_prefill(m, x, cfg, chunk=chunk)[0]


def mamba_prefill(m: Mamba, x, cfg, cache_dtype=torch.bfloat16, chunk=None):
    """``mamba_apply`` and the decode state after S tokens from one pass:
    h_S (f32) is the chunked scan's final state, and the conv window holds
    the last conv−1 *pre-conv* inputs in ``cache_dtype``, left-padded with
    zeros when S < conv − 1 (the rows the cache-free forward's causal conv
    sees before the first token)."""
    B, S, _ = x.shape
    xb, z = (x @ m.in_proj).chunk(2, dim=-1)
    xb = constrain(xb, "batch", None, "ff")
    xc, _ = causal_conv(m, xb)
    xc = constrain(F.silu(xc), "batch", None, "ff")
    dt, Bm, Cm = _split_xdbc(m, xc, cfg)
    A = -torch.exp(m.A_log)

    def make_ab(ci):
        return _discretize(ci["dt"], ci["x"], ci["B"], A)

    def emit(ci, h):
        return _readout(m, h, ci["C"], ci["x"])

    h0 = torch.zeros((B,) + tuple(m.A_log.shape), dtype=torch.float32,
                     device=x.device)
    y, h = chunked_linear_scan({"x": xc, "dt": dt, "B": Bm, "C": Cm}, h0,
                               make_ab, emit, chunk=chunk or cfg.scan_chunk)
    y = constrain(y * F.silu(z), "batch", None, "ff")
    y = constrain(y @ m.out_proj, "batch", None, None)
    K = m.conv_w.shape[0]
    tail = xb[:, max(S - (K - 1), 0):]
    tail = F.pad(tail, (0, 0, K - 1 - tail.shape[1], 0))
    return y, {"h": h, "conv": tail.to(cache_dtype)}


def init_mamba_state(cfg, B, dtype=torch.float32, device=None):
    di = cfg.ssm_expand * cfg.d_model
    return {"h": torch.zeros((B, di, cfg.ssm_state), dtype=torch.float32,
                             device=device),
            "conv": torch.zeros((B, cfg.ssm_conv - 1, di), dtype=dtype,
                                device=device)}


def mamba_decode(m: Mamba, x, cfg, state):
    """One token: x (B, 1, d) → (y (B, 1, d), new state {h, conv})."""
    xb, z = (x @ m.in_proj).chunk(2, dim=-1)
    xc, conv_tail = causal_conv(m, xb, init=state["conv"])
    xc = F.silu(xc)
    dt, Bm, Cm = _split_xdbc(m, xc, cfg)
    a, b = _discretize(dt[:, 0], xc[:, 0], Bm[:, 0], -torch.exp(m.A_log))
    h = a * state["h"] + b
    y = torch.einsum("bdn,bn->bd", h, Cm[:, 0].float())
    y = (y + m.D * xc[:, 0].float()).to(x.dtype)[:, None]
    return (y * F.silu(z)) @ m.out_proj, {"h": h, "conv": conv_tail}
