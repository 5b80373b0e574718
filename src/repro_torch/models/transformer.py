"""The LM stack for serving: per-layer blocks in one flat ``nn.ModuleList``
(the JAX package stacks parameters per cycle position and scans over
cycle groups; the port keeps layer order and loops), full-sequence
prefill that fills the decode state, and single-token decode.

Carries the decoder-only kinds of the serving path: global ('attn') and
sliding-window ('local') attention blocks, RG-LRU blocks, dense MLPs and
Mamba blocks (mixer only, no MLP).  MoE, the VLM prefix and the
encoder–decoder raise NotImplementedError when the model is built.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .._device import resolve_device
from .attention import (Attention, attention, attn_init, decode_attention,
                        init_kv_cache, prefill_attention)
from .common import RMSNorm, embed_init, softcap
from .mamba import (Mamba, init_mamba_state, mamba_apply, mamba_decode,
                    mamba_init, mamba_prefill)
from .mlp import MLP, mlp, mlp_init
from .rglru import (RGLRU, init_rglru_state, rglru_apply, rglru_decode,
                    rglru_init, rglru_prefill)

__all__ = [
    "Block", "Transformer", "check_supported", "init_params", "block_fwd",
    "embed_tokens", "logits_of", "prefill", "init_decode_state",
    "block_decode", "decode_step",
]

_ATTN = ("attn", "local")


def check_supported(cfg) -> None:
    """Raise NotImplementedError for what this slice of the port lacks."""
    later = None
    if cfg.moe:
        later = "MoE layers (models/moe.py) come with a later slice"
    elif cfg.family == "vlm":
        later = "the VLM patch-embedding prefix comes with a later slice"
    elif cfg.encoder_decoder:
        later = ("the encoder–decoder with cross-attention comes with a "
                 "later slice")
    elif not set(cfg.cycle) <= {"attn", "local", "rglru", "mamba"}:
        later = f"block kinds {cfg.cycle} are not ported"
    if later:
        raise NotImplementedError(f"{cfg.name}: {later}")


class Block(nn.Module):
    """One layer: pre-norm mixer (attention, RG-LRU or Mamba) and, except
    for Mamba, a pre-norm MLP residual, with gemma2's post-norms where the
    config has them."""

    def __init__(self, cfg, kind, device=None, dtype=None):
        super().__init__()
        d = cfg.d_model
        self.kind = kind
        self.norm1 = RMSNorm(d, device)
        if kind in _ATTN:
            self.mixer = Attention(cfg, kind, device, dtype)
        elif kind == "mamba":
            self.mixer = Mamba(cfg, device, dtype)
        else:
            self.mixer = RGLRU(cfg, device, dtype)
        post = cfg.post_norm and kind in _ATTN
        self.post1 = RMSNorm(d, device) if post else None
        has_mlp = kind != "mamba"
        self.norm2 = RMSNorm(d, device) if has_mlp else None
        self.mlp = MLP(d, cfg.d_ff, device, dtype) if has_mlp else None
        self.post2 = RMSNorm(d, device) if post else None


class Transformer(nn.Module):
    """embed (vocab, d), the layers, final_norm, and unembed unless tied.

    Matrices are stored in ``dtype`` (default ``cfg.compute_dtype``; see
    ``models/common.py``), norm scales, ``lam`` and Mamba's vectors and
    ``A_log`` in f32.  Serving only: no parameter takes a gradient.
    """

    def __init__(self, cfg, device=None, dtype=None):
        super().__init__()
        check_supported(cfg)
        dtype = dtype or cfg.compute_dtype
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model, **kw))
        self.layers = nn.ModuleList(Block(cfg, kind, device, dtype)
                                    for kind in cfg.layer_kinds())
        self.final_norm = RMSNorm(cfg.d_model, device)
        self.unembed = (None if cfg.tie_embeddings else nn.Parameter(
            torch.empty(cfg.vocab, cfg.d_model, **kw)))
        self.requires_grad_(False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens):
        """Logits at every position, (B, S, vocab): the blocks run
        full-sequence with no cache."""
        cfg = self.cfg
        tokens = _tokens(tokens, self.device)
        h = embed_tokens(self, tokens)
        positions = _positions(tokens)
        for blk in self.layers:
            h = block_fwd(blk, h, cfg, positions)
        return logits_of(self, self.final_norm(h, cfg.norm_eps))


def init_params(cfg, generator, device=None, dtype=None) -> Transformer:
    """A model of ``cfg`` with random weights from ``generator`` (a
    ``torch.Generator`` on ``device``): truncated normals as in the JAX
    package's initialisers, zero norm scales and biases, ``lam`` as in the
    RG-LRU init, Mamba's A, Δ bias and D as in its init.  The numbers
    differ from JAX's for the same seed; the distributions are the same."""
    model = Transformer(cfg, device=resolve_device(device), dtype=dtype)
    embed_init(model.embed, generator)
    for blk in model.layers:
        if blk.kind in _ATTN:
            attn_init(blk.mixer, cfg, generator)
        elif blk.kind == "mamba":
            mamba_init(blk.mixer, generator)
        else:
            rglru_init(blk.mixer, generator)
        if blk.mlp is not None:
            mlp_init(blk.mlp, generator)
    if model.unembed is not None:
        embed_init(model.unembed, generator)
    return model


def _tokens(tokens, device) -> torch.Tensor:
    return torch.as_tensor(tokens, device=device).long()


def _positions(tokens):
    B, S = tokens.shape
    return torch.arange(S, device=tokens.device).expand(B, S)


def _post(blk, name, y, cfg):
    norm = getattr(blk, name)
    return y if norm is None else norm(y, cfg.norm_eps)


def block_fwd(blk: Block, h, cfg, positions):
    """One block, full sequence, no cache."""
    hn = blk.norm1(h, cfg.norm_eps)
    if blk.kind == "mamba":
        return h + mamba_apply(blk.mixer, hn, cfg)
    if blk.kind in _ATTN:
        y = attention(blk.mixer, hn, cfg, blk.kind, positions)
        h = h + _post(blk, "post1", y, cfg)
    else:
        h = h + rglru_apply(blk.mixer, hn, cfg)
    y2 = mlp(blk.mlp, blk.norm2(h, cfg.norm_eps), cfg.mlp)
    return h + _post(blk, "post2", y2, cfg)


def embed_tokens(model: Transformer, tokens):
    h = model.embed[tokens]
    if model.cfg.embed_scale:
        # √d rounded to the compute dtype before the multiply, as JAX does
        h = h * torch.tensor(math.sqrt(model.cfg.d_model), dtype=h.dtype,
                             device=h.device)
    return h


def logits_of(model: Transformer, h):
    table = model.embed if model.unembed is None else model.unembed
    return softcap(h @ table.T, model.cfg.final_softcap)


# ---------------------------------------------------------------------------
# serving: prefill + single-token decode with a per-layer state
# ---------------------------------------------------------------------------
def _check_cache_room(pos: int, n: int, max_len: int) -> None:
    """Raise unless positions [pos, pos + n) fit a global attention
    layer's cache of ``max_len`` positions.  (The JAX package drops such
    writes and decodes on without those keys.)"""
    if pos + n > max_len:
        raise ValueError(f"a KV-cache write of {n} token(s) at pos {pos} "
                         f"runs past max_len {max_len} of the global "
                         f"attention cache")


def prefill(model: Transformer, batch, max_len: int,
            cache_dtype=torch.bfloat16):
    """Full forward over batch['tokens'] (B, S) that returns the last
    position's logits (B, vocab) and the decode state: ``pos`` (an int)
    and one cache per layer — KV (a ring buffer for local layers) or the
    RG-LRU's or Mamba's (h, conv window).  ``cache_dtype`` defaults to
    bf16 even for an f32 model, as in the JAX package.  Raises ValueError
    when S > ``max_len`` and the model has a global attention layer."""
    cfg = model.cfg
    tokens = _tokens(batch["tokens"], model.device)
    if any(blk.kind == "attn" for blk in model.layers):
        _check_cache_room(0, tokens.shape[1], max_len)
    h = embed_tokens(model, tokens)
    positions = _positions(tokens)
    caches = []
    for blk in model.layers:
        hn = blk.norm1(h, cfg.norm_eps)
        if blk.kind == "mamba":
            y, cache = mamba_prefill(blk.mixer, hn, cfg, cache_dtype)
            h = h + y
            caches.append(cache)
            continue
        if blk.kind in _ATTN:
            y, cache = prefill_attention(blk.mixer, hn, cfg, blk.kind,
                                         positions, max_len, cache_dtype)
            h = h + _post(blk, "post1", y, cfg)
        else:
            y, cache = rglru_prefill(blk.mixer, hn, cfg, cache_dtype)
            h = h + y
        y2 = mlp(blk.mlp, blk.norm2(h, cfg.norm_eps), cfg.mlp)
        h = h + _post(blk, "post2", y2, cfg)
        caches.append(cache)
    h = model.final_norm(h[:, -1:], cfg.norm_eps)
    return logits_of(model, h)[:, 0], {"pos": tokens.shape[1],
                                       "layers": caches}


def init_decode_state(cfg, B, max_len, cache_dtype=torch.bfloat16,
                      device=None):
    """Zeroed decode state, one cache per layer in layer order."""
    dev = resolve_device(device)
    layers = [init_kv_cache(cfg, B, max_len, kind, cache_dtype, device=dev)
              if kind in _ATTN else
              init_mamba_state(cfg, B, cache_dtype, device=dev)
              if kind == "mamba" else
              init_rglru_state(cfg, B, cache_dtype, device=dev)
              for kind in cfg.layer_kinds()]
    return {"pos": 0, "layers": layers}


def block_decode(blk: Block, h, cfg, cache, pos):
    """One block, one token. Returns (h, the layer's new cache)."""
    hn = blk.norm1(h, cfg.norm_eps)
    if blk.kind == "mamba":
        y, cache = mamba_decode(blk.mixer, hn, cfg, cache)
        return h + y, cache
    if blk.kind in _ATTN:
        y = decode_attention(blk.mixer, hn, cfg, blk.kind, cache, pos)
        h = h + _post(blk, "post1", y, cfg)
    else:
        y, cache = rglru_decode(blk.mixer, hn, cfg, cache)
        h = h + y
    y2 = mlp(blk.mlp, blk.norm2(h, cfg.norm_eps), cfg.mlp)
    return h + _post(blk, "post2", y2, cfg), cache


def decode_step(model: Transformer, tokens, state):
    """One decode step. tokens (B, 1) → (logits (B, vocab), new state).

    KV caches are written in place, so ``state`` is consumed.  Raises
    ValueError, before any write, when ``pos`` has reached the length of
    a global attention layer's cache (local layers are rings)."""
    cfg = model.cfg
    pos = state["pos"]
    for blk, cache in zip(model.layers, state["layers"]):
        if blk.kind == "attn":
            _check_cache_room(pos, 1, cache["k"].shape[1])
            break
    h = embed_tokens(model, _tokens(tokens, model.device))
    caches = []
    for blk, cache in zip(model.layers, state["layers"]):
        h, cache = block_decode(blk, h, cfg, cache, pos)
        caches.append(cache)
    h = model.final_norm(h, cfg.norm_eps)
    return logits_of(model, h)[:, 0], {"pos": pos + 1, "layers": caches}
