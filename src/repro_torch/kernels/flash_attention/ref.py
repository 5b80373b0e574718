"""Plain PyTorch version of the flash attention kernel: the full score
matrix in f32."""
from __future__ import annotations

import torch

__all__ = ["NEG_INF", "attention_ref"]

NEG_INF = -1e30


def attention_ref(q, k, v, *, causal=True, window=None, cap=None):
    """Naive full-matrix attention. q (B,S,H,hd) pre-scaled; k/v (B,T,K,hd),
    H = G·K (query head h reads kv head h // G).  Returns q's dtype."""
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, hd)
    s = torch.einsum("bskgd,btkd->bkgst", qg.float(), k.float())
    if cap is not None:
        s = cap * torch.tanh(s / cap)
    q_pos = torch.arange(S, device=q.device)[:, None]
    k_pos = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= (q_pos - k_pos) < window
    s = torch.where(mask, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,btkd->bskgd", w, v.float())
    return o.reshape(B, S, H, hd).to(q.dtype)
