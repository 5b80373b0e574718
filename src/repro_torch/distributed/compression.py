"""Gradient compression: int8 block quantization with error feedback.

The quantization residual is carried in a state dict and added back
before the next step's quantization, so the compression error stays
O(1) over training instead of O(steps).  The port has one process per
card and no cross-pod reduction yet, so, as in the JAX package under
GSPMD, these functions wrap the gradient *values*
(quantize → dequantize); a collective placed between the two would move
int8.  ``torch.round`` rounds half to even as ``jnp.round`` does, so the
codes equal the JAX package's.

Gradients are a dict of tensors (parameter name → gradient).
"""
from __future__ import annotations

import torch

__all__ = ["int8_compress", "make_error_feedback_compressor",
           "init_ef_state"]

_BLOCK = 256


def _quantize(x, block=_BLOCK):
    """Blockwise symmetric int8 quantization of x in f32.  Returns
    (codes (n_blocks, block) int8, scales (n_blocks, 1) f32, n)."""
    flat = x.float().reshape(-1)
    n = flat.shape[0]
    pad = (-n) % block
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blk = flat.reshape(-1, block)
    scale = blk.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blk / scale), -127, 127).to(torch.int8)
    return q, scale, n


def _dequantize(q, scale, n, shape):
    out = (q.float() * scale).reshape(-1)[:n]
    return out.reshape(shape)


def int8_compress(x):
    """Quantize → dequantize round trip (the traffic-equivalent value),
    in f32."""
    q, s, n = _quantize(x)
    return _dequantize(q, s, n, x.shape)


def init_ef_state(grads):
    """Zero residuals in f32, one per gradient."""
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()}


def make_error_feedback_compressor():
    """Stateful compressor: compress(grads, ef) → (grads', ef') with
    grads' = Q(grads + ef) and ef' = (grads + ef) − grads'."""

    def compress(grads, ef_state):
        out, ef = {}, {}
        for k, g in grads.items():
            v = g.float() + ef_state[k]
            c = int8_compress(v)
            out[k], ef[k] = c, v - c
        return out, ef

    return compress
