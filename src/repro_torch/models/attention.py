"""Attention: GQA/MQA/MHA with RoPE, sliding window, logit softcap and
QKV bias.  Full-sequence attention goes through the flash attention op
(``kernels/flash_attention``: the CUDA kernel on the card, its plain
version on the CPU); single-token decode over the KV cache is plain
PyTorch, as in the JAX package.  Decoder cross-attention reads encoder
K/V computed once a layer (``cross_kv``): full-sequence through the same
op (not causal, T = the encoder's length), at decode plain PyTorch.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..distributed.sharding import active_mesh, constrain, heads_shardable
from ..kernels.flash_attention.ops import flash_attention_op
from .common import dense_init, matmul_f32acc, rope, softcap

__all__ = [
    "NEG_INF",
    "Attention",
    "attn_init",
    "qkv",
    "attention",
    "cross_kv",
    "cross_attention",
    "cross_decode_attention",
    "prefill_attention",
    "init_kv_cache",
    "cache_slots",
    "cache_update",
    "decode_attention",
]

NEG_INF = -1e30


def _kv_heads(cfg, kind):
    if kind == "local" and cfg.local_kv_heads:
        return cfg.local_kv_heads
    return cfg.n_kv_heads


class Attention(nn.Module):
    """wq (d, H·hd), wk/wv (d, K·hd), wo (H·hd, d), optional biases; the
    JAX package's (d, H, hd) and (H, hd, d) layouts flattened."""

    def __init__(self, cfg, kind="attn", device=None, dtype=None):
        super().__init__()
        d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
        K = _kv_heads(cfg, kind)
        kw = dict(device=device, dtype=dtype)
        self.wq = nn.Parameter(torch.empty(d, H * hd, **kw))
        self.wk = nn.Parameter(torch.empty(d, K * hd, **kw))
        self.wv = nn.Parameter(torch.empty(d, K * hd, **kw))
        self.wo = nn.Parameter(torch.empty(H * hd, d, **kw))
        if cfg.qkv_bias:
            self.bq = nn.Parameter(torch.zeros(H * hd, **kw))
            self.bk = nn.Parameter(torch.zeros(K * hd, **kw))
            self.bv = nn.Parameter(torch.zeros(K * hd, **kw))
        else:
            self.bq = self.bk = self.bv = None


def attn_init(m: Attention, cfg, generator) -> Attention:
    d = cfg.d_model
    std = 1.0 / math.sqrt(d)
    dense_init(m.wq, d, generator)
    dense_init(m.wk, d, generator)
    dense_init(m.wv, d, generator)
    dense_init(m.wo, m.wo.shape[0], generator,
               std=std / math.sqrt(2 * cfg.n_layers))
    return m


def _whole_heads(t, hd, name):
    """A projection (B, S, heads·hd) placed, on a mesh, so that its
    flattened axis splits into (heads, hd): sharded by the logical
    ``name`` ("heads", "kv_heads") where the heads divide the "model"
    axis, else whole (the JAX package's projections are (B, S, heads,
    hd) from the start)."""
    if active_mesh() is None:
        return t
    n = t.shape[-1] // hd
    return constrain(t, "batch", None, name if heads_shardable(n) else None)


def qkv(m: Attention, x, cfg, positions):
    """q (pre-scaled by hd^-0.5 after rope, in x's dtype), k, v:
    (B, S, heads, hd) each."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q, k, v = x @ m.wq, x @ m.wk, x @ m.wv
    if m.bq is not None:
        q, k, v = q + m.bq, k + m.bk, v + m.bv
    q, k, v = (_whole_heads(q, hd, "heads"), _whole_heads(k, hd, "kv_heads"),
               _whole_heads(v, hd, "kv_heads"))
    q = rope(q.view(B, S, -1, hd), positions, cfg.rope_theta)
    k = rope(k.view(B, S, -1, hd), positions, cfg.rope_theta)
    q = q * (hd ** -0.5)
    return q, k, v.view(B, S, -1, hd)


def _out(m: Attention, o):
    """The output projection, placed as the residual stream (what the JAX
    package's partitioner gives a row-parallel product's output)."""
    B, S = o.shape[:2]
    return constrain(o.reshape(B, S, -1) @ m.wo, "batch", None, None)


def _attn_sharding(q, k, cfg):
    """q and k placed for attention, and the spec of its output: TP over
    heads when they divide the mesh's "model" axis, else context
    parallelism over the query sequence (k whole), so that attention's
    compute shards "model"-ways either way, as in the JAX package."""
    if heads_shardable(cfg.n_heads):
        spec = ("batch", None, "heads", None)
        kspec = ("batch", None, "kv_heads", None)
    else:
        spec = ("batch", "seq_mp", None, None)
        kspec = ("batch", None, None, None)
    q = constrain(q, *spec) if q is not None else None
    k = constrain(k, *kspec) if k is not None else None
    return q, k, spec


def _attend(m: Attention, x, cfg, kind, positions):
    """(output (B, S, d), k, v) of full-sequence self-attention: 'attn'
    (global causal), 'local' (sliding window causal) or 'bidir' (no
    mask)."""
    q, k, v = qkv(m, x, cfg, positions)
    q, k, spec = _attn_sharding(q, k, cfg)
    o = flash_attention_op(q, k, v, causal=kind != "bidir",
                           window=cfg.window if kind == "local" else None,
                           cap=cfg.attn_softcap)
    return _out(m, constrain(o, *spec)), k, v


def attention(m: Attention, x, cfg, kind, positions):
    """Full-sequence self-attention of ``kind`` (see ``_attend``)."""
    return _attend(m, x, cfg, kind, positions)[0]


def _cross_q(m: Attention, x, cfg):
    """Cross-attention queries: no rope, pre-scaled, (B, S, H, hd)."""
    B, S, _ = x.shape
    q = x @ m.wq
    if m.bq is not None:
        q = q + m.bq
    q = _whole_heads(q, cfg.head_dim, "heads")
    return q.view(B, S, -1, cfg.head_dim) * (cfg.head_dim ** -0.5)


def cross_kv(m: Attention, enc_out, cfg):
    """Encoder K/V of a decoder layer's cross-attention, (B, T, K, hd)
    each, with the biases and no rope."""
    B, T, _ = enc_out.shape
    k, v = enc_out @ m.wk, enc_out @ m.wv
    if m.bk is not None:
        k, v = k + m.bk, v + m.bv
    k, v = (_whole_heads(t, cfg.head_dim, "kv_heads") for t in (k, v))
    return k.view(B, T, -1, cfg.head_dim), v.view(B, T, -1, cfg.head_dim)


def cross_attention(m: Attention, x, cfg, kv):
    """Full-sequence decoder cross-attention of x (B, S, d) over the
    encoder's ``kv`` (``cross_kv``): every key visible, the config's
    softcap."""
    k, v = kv
    o = flash_attention_op(_cross_q(m, x, cfg), k, v, causal=False,
                           window=None, cap=cfg.attn_softcap)
    return _out(m, constrain(o, *_attn_sharding(o, None, cfg)[2]))


def prefill_attention(m: Attention, x, cfg, kind, positions, max_len,
                      cache_dtype=torch.bfloat16):
    """Full-sequence attention that also returns a populated KV cache.

    Global layers cache all S positions into a (B, max_len, K, hd)
    buffer; local layers keep a ring buffer of the last
    C = min(max_len, window) positions, position t at slot t % C.
    """
    B, S, _ = x.shape
    y, k, v = _attend(m, x, cfg, kind, positions)
    cache = init_kv_cache(cfg, B, max_len, kind, cache_dtype, device=x.device)
    C = cache["k"].shape[1]
    n_keep = min(S, C)
    cache_update(cache, k[:, S - n_keep:], v[:, S - n_keep:], S - n_keep,
                 kind=kind)
    return y, cache


# ---------------------------------------------------------------------------
# KV-cache decode path
# ---------------------------------------------------------------------------
def init_kv_cache(cfg, B, max_len, kind="attn", dtype=torch.bfloat16,
                  device=None):
    K, hd = _kv_heads(cfg, kind), cfg.head_dim
    if kind == "local":
        max_len = min(max_len, cfg.window or max_len)   # ring buffer
    shape = (B, max_len, K, hd)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def cache_slots(cache_len, pos, n, kind, device=None):
    """Cache slot indices for positions [pos, pos+n): ring for local."""
    t = pos + torch.arange(n, device=device)
    return t % cache_len if kind == "local" else t


def cache_update(cache, k_new, v_new, pos, kind="attn"):
    """Write k/v for positions [pos, pos+n) into the cache, in place (the
    JAX package returns a new cache; the port reuses the buffers)."""
    C = cache["k"].shape[1]
    slots = cache_slots(C, pos, k_new.shape[1], kind, k_new.device)
    cache["k"].index_copy_(1, slots, k_new.to(cache["k"].dtype))
    cache["v"].index_copy_(1, slots, v_new.to(cache["v"].dtype))
    return cache


def decode_attention(m: Attention, x, cfg, kind, cache, pos: int):
    """Single-token decode: q from x (B, 1, d) at position ``pos`` (the
    number of tokens already in the cache), attending over the cache.
    Updates the cache in place and returns the output (B, 1, d)."""
    B = x.shape[0]
    positions = torch.full((B, 1), pos, dtype=torch.int64, device=x.device)
    q, k_new, v_new = qkv(m, x, cfg, positions)
    cache_update(cache, k_new, v_new, pos, kind=kind)
    k, v = cache["k"], cache["v"]
    C, K, hd = k.shape[1], k.shape[2], k.shape[3]
    H = q.shape[2]
    qg = q.reshape(B, 1, K, H // K, hd)
    # scores in f32 from k in q's dtype; p in v's dtype, summed in f32
    s = matmul_f32acc("bqkgd,btkd->bkgqt", qg, k.to(qg.dtype))
    s = softcap(s, cfg.attn_softcap)
    t_idx = torch.arange(C, device=x.device)
    if kind == "local":
        # ring buffer: slot t holds absolute position p ≡ t (mod C), the
        # latest such p ≤ pos
        abs_pos = pos - torch.remainder(pos - t_idx, C)
        valid = (abs_pos >= 0) & (abs_pos <= pos)
        if cfg.window is not None:
            valid &= (pos - abs_pos) < cfg.window
    else:
        valid = t_idx <= pos
    s = torch.where(valid, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = matmul_f32acc("bkgqt,btkd->bqkgd", w.to(v.dtype), v)
    return _out(m, o.reshape(B, 1, H, hd).to(x.dtype))


def cross_decode_attention(m: Attention, x, cfg, kv):
    """Cross-attention of one decoder token x (B, 1, d) over the encoder's
    ``kv``: no mask and no softcap, as in the JAX package."""
    B = x.shape[0]
    q = _cross_q(m, x, cfg)
    k, v = kv
    K, hd = k.shape[2], k.shape[3]
    H = q.shape[2]
    qg = q.reshape(B, 1, K, H // K, hd)
    s = matmul_f32acc("bqkgd,btkd->bkgqt", qg, k.to(qg.dtype))
    w = torch.softmax(s, dim=-1)
    o = matmul_f32acc("bkgqt,btkd->bqkgd", w.to(v.dtype), v)
    return _out(m, o.reshape(B, 1, H, hd).to(x.dtype))
