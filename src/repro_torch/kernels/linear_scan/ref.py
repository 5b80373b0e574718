"""Plain PyTorch version of the linear scan kernel: a loop over t in f32."""
from __future__ import annotations

import torch

__all__ = ["linear_scan_ref"]


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
