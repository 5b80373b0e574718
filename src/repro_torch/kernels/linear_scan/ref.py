"""Plain PyTorch versions of the linear scan kernels: loops over t in f32."""
from __future__ import annotations

import torch

__all__ = ["linear_scan_ref", "linear_scan_bwd_ref"]


def linear_scan_ref(a, b):
    """h_t = a_t h_{t−1} + b_t with h_{-1} = 0; a, b: (B, S, D).  The state
    is f32; the result comes back in a's dtype."""
    a32, b32 = a.float(), b.float()
    hs = torch.empty_like(a32)
    h = torch.zeros_like(a32[:, 0])
    for t in range(a.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        hs[:, t] = h
    return hs.to(a.dtype)


def linear_scan_bwd_ref(a, h, dh):
    """The gradients of ``linear_scan_ref`` from a, its output h and the
    output's gradient dh, each (B, S, D): the reverse loop
    g_t = dh_t + a_{t+1} g_{t+1} in f32, db = g, da_t = g_t h_{t−1} with
    h_{−1} = 0.  (da, db) come back in a's dtype."""
    a32, dh32 = a.float(), dh.float()
    g = torch.empty_like(dh32)
    acc = dh32[:, -1].clone()
    g[:, -1] = acc
    for t in range(a.shape[1] - 2, -1, -1):
        acc = torch.addcmul(dh32[:, t], a32[:, t + 1], acc)
        g[:, t] = acc
    h_prev = torch.zeros_like(g)
    h_prev[:, 1:] = h[:, :-1]
    return (g * h_prev).to(a.dtype), g.to(a.dtype)
