"""Shared model building blocks: initialisers and the plain math (norms,
rotary embeddings, the causal conv of the recurrent mixers).

Conventions (as in the JAX package, with PyTorch idiom):
  * parameters live in ``nn.Module``s; the math is plain functions on
    tensors that take those modules;
  * every initialiser draws from an explicit ``torch.Generator``;
  * the compute dtype is ``cfg.compute_dtype`` (bf16 by default).  The
    JAX package keeps parameters in f32 and casts them to the activation
    dtype at every use; the port stores the matrices once in the compute
    dtype, which rounds them the same way and saves re-casting every
    weight at every decode step.  Norm scales and the RG-LRU ``lam``
    stay f32, as the JAX code uses them.
"""
from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..distributed.sharding import constrain, logsumexp_last, take_last

__all__ = [
    "trunc_normal",
    "dense_init",
    "embed_init",
    "RMSNorm",
    "rmsnorm",
    "rope",
    "softcap",
    "matmul_f32acc",
    "causal_conv",
    "cross_entropy",
    "chunked_cross_entropy",
]


def trunc_normal(t: torch.Tensor, std: float, generator) -> torch.Tensor:
    """Fill ``t`` in place with std·N(0, 1) truncated to ±2 (±2σ), drawn
    in f32 and rounded once to ``t``'s dtype."""
    x = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=generator)
    with torch.no_grad():
        t.copy_(x.mul_(float(std)))
    return t


def dense_init(t: torch.Tensor, d_in: int, generator, std=None):
    """A (d_in, d_out…) projection: truncated normal, std 1/√d_in."""
    return trunc_normal(t, std if std is not None else 1.0 / math.sqrt(d_in),
                        generator)


def embed_init(t: torch.Tensor, generator, std: float = 0.02):
    return trunc_normal(t, std, generator)


class RMSNorm(nn.Module):
    """Holds an f32 ``scale`` (zeros at init: the norm multiplies by
    1 + scale)."""

    def __init__(self, d: int, device=None):
        super().__init__()
        self.scale = nn.Parameter(torch.zeros(d, dtype=torch.float32,
                                              device=device))

    def forward(self, x, eps: float):
        return rmsnorm(x, self.scale, eps)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6):
    """x·rsqrt(mean(x²) + eps)·(1 + scale), computed in f32."""
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale)).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0):
    """Rotary embedding, half-split layout (the first and second halves of
    head_dim are the pair), angles in f32.

    x: (..., seq, heads, head_dim); positions: (..., seq).
    """
    hd = x.shape[-1]
    half = hd // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = positions[..., :, None].float() * freq          # (..., S, half)
    ang = ang[..., :, None, :]                            # (..., S, 1, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap):
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


def matmul_f32acc(eq: str, a: torch.Tensor, b: torch.Tensor):
    """``einsum(eq, a, b)`` summed in f32 and returned in f32, as JAX's
    ``preferred_element_type=float32`` does: bf16 operands are exact in
    f32 and so are their products."""
    return torch.einsum(eq, a.float(), b.float())


def causal_conv(m, x, init=None):
    """Depthwise causal conv with the ``conv_w`` (conv, w) and ``conv_b``
    (w) of ``m`` (an RG-LRU or Mamba mixer).  x: (B, S, w); init:
    (B, conv−1, w) in any float dtype (the two are joined in their
    promoted dtype, as jnp's concatenate does).  Returns (out, the last
    conv−1 inputs)."""
    w = m.conv_w.to(x.dtype)
    K = w.shape[0]
    if init is None:
        init = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                           device=x.device)
    dt = torch.promote_types(init.dtype, x.dtype)
    xp = torch.cat([init.to(dt), x.to(dt)], dim=1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * w[i] for i in range(K))
    tail = xp[:, -(K - 1):] if K > 1 else None
    return out + m.conv_b.to(x.dtype), tail


def cross_entropy(logits, labels, mask=None):
    """Mean token cross-entropy over logits (B, S, V) in f32; labels < 0
    (and positions where ``mask`` is 0) are ignored."""
    labels = torch.as_tensor(labels, device=logits.device).long()
    valid = labels >= 0
    if mask is not None:
        valid = valid & (torch.as_tensor(mask, device=logits.device) > 0)
    logits = constrain(logits.float(), "batch", None, "vocab")
    lse = logsumexp_last(logits)
    gold = constrain(take_last(logits, labels.clamp_min(0)[..., None]),
                     "batch", None, None)[..., 0]
    nll = (lse - gold) * valid
    return nll.sum() / valid.sum().clamp_min(1)


def _chunk_nll(hc, table, lc, final_softcap):
    """Summed NLL and valid count of one chunk: hc (B, c, d), lc (B, c)."""
    logits = softcap(hc @ table.to(hc.dtype).T, final_softcap)
    logits = constrain(logits.float(), "batch", None, "vocab")
    valid = lc >= 0
    lse = logsumexp_last(logits)
    # the gold logit placed as the batch before its last axis goes: over
    # a vocab-sharded mesh that reduces the masked partial sums
    gold = constrain(take_last(logits, lc.clamp_min(0)[..., None]),
                     "batch", None, None)[..., 0]
    return ((lse - gold) * valid).sum(), valid.sum().float()


def chunked_cross_entropy(h, table, labels, cfg, chunk: int = 512):
    """Fused unembed + cross-entropy over sequence chunks of ``chunk``.

    h (B, S, d), table (V, d), labels (B, S) with < 0 ignored.  Each
    chunk's (B, c, V) logits exist only inside one non-reentrant
    ``torch.utils.checkpoint``, which recomputes them in the backward
    pass (the JAX package's ``jax.checkpoint`` scan); the last chunk is
    padded with −1 labels.  Returns the mean NLL over valid labels.
    """
    labels = torch.as_tensor(labels, device=h.device).long()
    B, S = labels.shape
    c = min(chunk, S)
    nc = -(-S // c)
    pad = nc * c - S
    if pad:
        h = torch.nn.functional.pad(h, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad), value=-1)
    nll = torch.zeros((), dtype=torch.float32, device=h.device)
    n = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(nc):
        sl = slice(i * c, (i + 1) * c)
        part, cnt = checkpoint(_chunk_nll, h[:, sl], table, labels[:, sl],
                               cfg.final_softcap, use_reentrant=False)
        nll = nll + part
        n = n + cnt
    return nll / n.clamp_min(1.0)
