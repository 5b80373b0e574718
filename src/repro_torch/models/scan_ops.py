"""Chunked diagonal linear recurrences over the linear scan kernel (K4).

Mamba-1 (and RG-LRU) reduce to the elementwise recurrence

    h_t = a_t ⊙ h_{t−1} + b_t .

``chunked_linear_scan`` runs it over a long sequence chunk by chunk:
each chunk's (a, b) — for Mamba the (B, c, d_inner, N) discretized
tensors — is built from that chunk's inputs only, scanned by
``linear_scan_op`` (the CUDA kernel on the card, its plain version on
the CPU) with the carried state folded into the chunk's first step, and
turned into the chunk's output before the next chunk is built.  The
full-sequence (B, S, …feature) a, b and h never exist at once.
"""
from __future__ import annotations

import math

import torch

from ..kernels.linear_scan.ops import linear_scan_op

__all__ = ["assoc_linear_scan", "chunked_linear_scan"]


def _scan_folded(a, b, h):
    """Every step of h_t = a_t h_{t−1} + b_t from state ``h`` (B, …feature)
    over a, b (B, c, …feature): the state is folded into step 0
    (b₀ ← a₀·h + b₀) and the feature axes are flattened into one (B, c, D)
    f32 call of K4.  ``b`` is overwritten."""
    Bsz, c = a.shape[:2]
    feat = a.shape[2:]
    D = math.prod(feat)
    a = a.float().reshape(Bsz, c, D).contiguous()
    b = b.float().reshape(Bsz, c, D).contiguous()
    b[:, 0] += a[:, 0] * h.float().reshape(Bsz, D)
    return linear_scan_op(a, b).reshape(Bsz, c, *feat)


def assoc_linear_scan(a, b, h0, axis=1):
    """All-timestep solution of h_t = a_t h_{t−1} + b_t, in f32.

    a, b: (B, S, …) along ``axis`` = 1; h0 broadcastable to a[:, 0].
    Returns h for every t (a's shape).
    """
    if axis != 1:
        raise NotImplementedError("axis must be 1 (B, S, …)")
    h0 = torch.as_tensor(h0, device=a.device).float().expand(a[:, 0].shape)
    return _scan_folded(a, b.float().clone(), h0)


def _mask(valid, ref):
    """(B, c) bool → broadcastable to ref (B, c, …feature)."""
    return valid.reshape(valid.shape + (1,) * (ref.ndim - valid.ndim))


def chunked_linear_scan(inputs, h0, make_ab, emit, chunk: int = 256):
    """Scan h_t = a_t h_{t−1} + b_t over a long sequence, chunk by chunk.

    Args:
      inputs: a dict of (B, S, …) tensors, consumed a chunk at a time.
      h0: (B, …feature) initial state.
      make_ab: chunk inputs → (a, b), each (B, c, …feature), fresh
        tensors (the scan folds the state into b in place).
      emit: (chunk inputs, h (B, c, …feature) in f32) → the chunk's
        output (B, c, …out).
      chunk: chunk length c = min(chunk, S).  The last chunk is padded
        with zero inputs to c steps; padded steps are forced to a = 1,
        b = 0 so they do not move the state.

    Returns (y (B, S, …out), h_final (B, …feature) in f32).
    """
    Bsz, S = next(iter(inputs.values())).shape[:2]
    c = min(chunk, S)
    nc = -(-S // c)
    h = h0.float()
    ys = []
    for i in range(nc):
        lo, hi = i * c, min((i + 1) * c, S)
        pad = c - (hi - lo)

        def take(x, lo=lo, hi=hi, pad=pad):
            x = x[:, lo:hi]
            if pad:
                x = torch.cat([x, x.new_zeros((Bsz, pad) + x.shape[2:])], 1)
            return x

        ci = {k: take(v) for k, v in inputs.items()}
        a, b = make_ab(ci)
        if pad:
            valid = torch.arange(c, device=a.device) < hi - lo
            valid = valid.expand(Bsz, c)
            a = torch.where(_mask(valid, a), a, 1.0)
            b = torch.where(_mask(valid, b), b, 0.0)
        h_all = _scan_folded(a, b, h)
        ys.append(emit(ci, h_all))
        h = h_all[:, -1]
    y = torch.cat(ys, 1) if nc > 1 else ys[0]
    return y[:, :S], h.clone()
