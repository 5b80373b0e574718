"""The LM stack: per-layer blocks in one flat ``nn.ModuleList`` (the JAX
package stacks parameters per cycle position and scans over cycle
groups; the port keeps layer order and loops), the training forward
``model_apply`` (loss and metrics, remat per layer), full-sequence
prefill that fills the decode state, and single-token decode.

Carries every kind the configs use: global ('attn') and sliding-window
('local') attention blocks with a dense MLP or a Mixture-of-Experts
layer, RG-LRU blocks, Mamba blocks (mixer only, no MLP), the VLM's
patch-embedding prefix (``frontend_proj``), and the encoder–decoder: a
stack of bidirectional encoder layers over ``batch["frames"]`` and
decoder layers with cross-attention (``norm_x``, ``cross``).
"""
from __future__ import annotations

import functools
import math

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from .._device import resolve_device
from ..distributed.sharding import batch_like, constrain, sharded_lookup
from .attention import (Attention, attention, attn_init, cross_attention,
                        cross_decode_attention, cross_kv, decode_attention,
                        init_kv_cache, prefill_attention)
from .common import (RMSNorm, chunked_cross_entropy, cross_entropy,
                     dense_init, embed_init, softcap)
from .mamba import (Mamba, init_mamba_state, mamba_apply, mamba_decode,
                    mamba_init, mamba_prefill)
from .mlp import MLP, mlp, mlp_init
from .moe import MoE, moe_apply, moe_init
from .rglru import (RGLRU, init_rglru_state, rglru_apply, rglru_decode,
                    rglru_init, rglru_prefill)

__all__ = [
    "Block", "Transformer", "check_supported", "init_params", "block_fwd",
    "embed_tokens", "logits_of", "model_apply", "prefill",
    "init_decode_state", "block_decode", "decode_step",
]

_ATTN = ("attn", "local")
_SELF_ATTN = ("attn", "local", "bidir")


def check_supported(cfg) -> None:
    """Raise NotImplementedError for a block kind the port lacks."""
    if not set(cfg.cycle) <= {"attn", "local", "rglru", "mamba"}:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {cfg.cycle} are not ported")


class Block(nn.Module):
    """One layer: pre-norm mixer (attention, RG-LRU or Mamba) and, except
    for Mamba, a pre-norm MLP residual (a MoE in an attention block of a
    MoE config), with gemma2's post-norms where the config has them.  A
    ``decoder`` layer of the encoder–decoder also holds ``norm_x`` and
    the cross-attention ``cross``."""

    def __init__(self, cfg, kind, device=None, dtype=None, decoder=False):
        super().__init__()
        d = cfg.d_model
        self.kind = kind
        self.norm1 = RMSNorm(d, device)
        if kind in _SELF_ATTN:
            self.mixer = Attention(cfg, kind, device, dtype)
        elif kind == "mamba":
            self.mixer = Mamba(cfg, device, dtype)
        else:
            self.mixer = RGLRU(cfg, device, dtype)
        post = cfg.post_norm and kind in _SELF_ATTN
        self.post1 = RMSNorm(d, device) if post else None
        has_mlp = kind != "mamba"
        self.norm2 = RMSNorm(d, device) if has_mlp else None
        if cfg.moe and kind in _SELF_ATTN:
            self.mlp = MoE(cfg, device, dtype)
        else:
            self.mlp = MLP(d, cfg.d_ff, device, dtype) if has_mlp else None
        self.post2 = RMSNorm(d, device) if post else None
        self.norm_x = RMSNorm(d, device) if decoder else None
        self.cross = Attention(cfg, "attn", device, dtype) if decoder else None


class Transformer(nn.Module):
    """embed (vocab, d), the layers, final_norm, and unembed unless tied;
    ``frontend_proj`` (patch_dim, d) with a frontend; the encoder's
    ``enc_layers`` and ``enc_norm`` in an encoder–decoder.

    Matrices are stored in ``dtype`` (default ``cfg.compute_dtype``; see
    ``models/common.py``); norm scales, ``lam``, Mamba's vectors and
    ``A_log``, and the MoE router in f32.  A serving model takes no
    gradient; one built with ``trainable=True`` does (training builds it
    in f32, the masters, and runs a cast copy: ``train/loop.py``).
    """

    def __init__(self, cfg, device=None, dtype=None, trainable=False):
        super().__init__()
        check_supported(cfg)
        dtype = dtype or cfg.compute_dtype
        self.cfg = cfg
        kw = dict(device=device, dtype=dtype)
        dec = cfg.encoder_decoder
        self.embed = nn.Parameter(torch.empty(cfg.vocab, cfg.d_model, **kw))
        self.layers = nn.ModuleList(Block(cfg, kind, device, dtype, dec)
                                    for kind in cfg.layer_kinds())
        self.final_norm = RMSNorm(cfg.d_model, device)
        self.unembed = (None if cfg.tie_embeddings else nn.Parameter(
            torch.empty(cfg.vocab, cfg.d_model, **kw)))
        self.frontend_proj = (nn.Parameter(
            torch.empty(cfg.patch_dim, cfg.d_model, **kw))
            if cfg.frontend else None)
        self.enc_layers = nn.ModuleList(
            Block(cfg, "bidir", device, dtype)
            for _ in range(cfg.n_enc_layers if dec else 0))
        self.enc_norm = RMSNorm(cfg.d_model, device) if dec else None
        self.requires_grad_(trainable)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    def forward(self, tokens, patches=None, frames=None):
        """Logits at every position, (B, St, vocab), St = the VLM's
        n_patches (with ``patches``) + S: the blocks run full-sequence
        with no cache.  An encoder–decoder needs ``frames``."""
        cfg = self.cfg
        h, positions = _embed_input(self, tokens, patches)
        enc_out = _encode(self, frames) if cfg.encoder_decoder else None
        h, _ = _run_layers(self.layers, h, cfg, positions, enc_out)
        return logits_of(self, self.final_norm(h, cfg.norm_eps))


def init_params(cfg, generator, device=None, dtype=None,
                trainable=False) -> Transformer:
    """A model of ``cfg`` with random weights from ``generator`` (a
    ``torch.Generator`` on ``device``): truncated normals as in the JAX
    package's initialisers, zero norm scales and biases, ``lam`` as in the
    RG-LRU init, Mamba's A, Δ bias and D as in its init, the MoE's as in
    ``moe_init``.  The numbers differ from JAX's for the same seed; the
    distributions are the same.  ``trainable``: see ``Transformer``."""
    model = Transformer(cfg, device=resolve_device(device), dtype=dtype,
                        trainable=trainable)
    embed_init(model.embed, generator)
    for blk in (*model.layers, *model.enc_layers):
        if blk.kind in _SELF_ATTN:
            attn_init(blk.mixer, cfg, generator)
        elif blk.kind == "mamba":
            mamba_init(blk.mixer, generator)
        else:
            rglru_init(blk.mixer, generator)
        if isinstance(blk.mlp, MoE):
            moe_init(blk.mlp, cfg, generator)
        elif blk.mlp is not None:
            mlp_init(blk.mlp, generator)
        if blk.cross is not None:
            attn_init(blk.cross, cfg, generator)
    if model.unembed is not None:
        embed_init(model.unembed, generator)
    if model.frontend_proj is not None:
        dense_init(model.frontend_proj, cfg.patch_dim, generator)
    return model


def _tokens(tokens, device) -> torch.Tensor:
    return torch.as_tensor(tokens, device=device).long()


def _positions(B, S, device, like=None):
    """(B, S) positions 0 … S − 1; split as ``like``'s rows where that is
    a ``DTensor``."""
    return batch_like(torch.arange(S, device=device).expand(B, S), like)


def _project(model: Transformer, x):
    """Patches or frames (B, n, patch_dim), any float dtype, through
    ``frontend_proj`` in the compute dtype."""
    w = model.frontend_proj
    return torch.as_tensor(x, device=model.device).to(w.dtype) @ w


def _embed_input(model: Transformer, tokens, patches=None):
    """(h (B, St, d), positions (B, St)): the token embeddings, after the
    projected patches when the VLM is given them (without, it serves
    text only, as the JAX package does)."""
    h = embed_tokens(model, _tokens(tokens, model.device))
    if model.cfg.family == "vlm" and patches is not None:
        h = torch.cat([_project(model, patches), h], dim=1)
    return h, _positions(h.shape[0], h.shape[1], h.device, h)


def _encode(model: Transformer, frames, remat="none"):
    """The encoder: frames (B, S_src, patch_dim) → enc_out (B, S_src, d)."""
    if frames is None:
        raise ValueError(f"{model.cfg.name} is an encoder–decoder: the "
                         f"batch needs 'frames'")
    cfg = model.cfg
    h = constrain(_project(model, frames), "batch", None, None)
    positions = _positions(h.shape[0], h.shape[1], h.device, h)
    h, _ = _run_layers(model.enc_layers, h, cfg, positions, remat=remat)
    return model.enc_norm(h, cfg.norm_eps)


# matrix products without a batch axis, which "dots" remat keeps (the
# JAX package's dots_with_no_batch_dims_saveable)
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _layer(blk, h, cfg, positions, enc_out):
    """One layer of a stack; a decoder layer computes its cross K/V from
    ``enc_out`` inside, so remat recomputes them too."""
    kv = None if enc_out is None else cross_kv(blk.cross, enc_out, cfg)
    return block_fwd(blk, h, cfg, positions, enc_kv=kv)


def _run_layers(layers, h, cfg, positions, enc_out=None, remat="none"):
    """The layers in order, each under ``remat``: "none"; "full" (a
    non-reentrant ``torch.utils.checkpoint``: the layer's forward runs
    again in the backward pass); "dots" (a selective checkpoint that
    keeps the matrix products' outputs and recomputes the rest).
    Returns (h, the layers' aux terms summed)."""
    if remat not in ("none", "full", "dots"):
        raise ValueError(f"unknown remat {remat!r}")
    aux = {}
    for blk in layers:
        args = (blk, h, cfg, positions, enc_out)
        if remat == "none" or not torch.is_grad_enabled():
            h, a = _layer(*args)
        elif remat == "full":
            h, a = checkpoint(_layer, *args, use_reentrant=False)
        else:
            h, a = checkpoint(_layer, *args, use_reentrant=False,
                              context_fn=functools.partial(
                                  create_selective_checkpoint_contexts,
                                  _dots_policy))
        for k, v in a.items():
            aux[k] = aux[k] + v if k in aux else v
    return h, aux


def _post(blk, name, y, cfg):
    norm = getattr(blk, name)
    return y if norm is None else norm(y, cfg.norm_eps)


def _ffn(blk, h, cfg):
    """The block's second residual branch on its pre-norm input: the MLP,
    or the MoE.  Returns (y, aux): the MoE's aux losses, else {}."""
    hn = blk.norm2(h, cfg.norm_eps)
    if isinstance(blk.mlp, MoE):
        return moe_apply(blk.mlp, hn, cfg)
    return mlp(blk.mlp, hn, cfg.mlp), {}


def _cross(blk, h, cfg, kv):
    if kv is None:
        return h
    return h + cross_attention(blk.cross, blk.norm_x(h, cfg.norm_eps), cfg,
                               kv)


def block_fwd(blk: Block, h, cfg, positions, enc_kv=None):
    """One block, full sequence, no cache; ``enc_kv`` the encoder K/V of
    a decoder layer's cross-attention.  Returns (h, aux): a MoE block's
    aux losses (``moe_lb``, ``moe_z``), else {}."""
    hn = blk.norm1(h, cfg.norm_eps)
    aux = {}
    if blk.kind == "mamba":
        h = h + mamba_apply(blk.mixer, hn, cfg)
    else:
        if blk.kind in _SELF_ATTN:
            y = attention(blk.mixer, hn, cfg, blk.kind, positions)
            h = _cross(blk, h + _post(blk, "post1", y, cfg), cfg, enc_kv)
        else:
            h = h + rglru_apply(blk.mixer, hn, cfg)
        y, aux = _ffn(blk, h, cfg)
        h = h + _post(blk, "post2", y, cfg)
    return constrain(h, "batch", None, None), aux


def embed_tokens(model: Transformer, tokens):
    table = model.embed
    h = (sharded_lookup(table, tokens) if hasattr(table, "device_mesh")
         else table[tokens])
    if model.cfg.embed_scale:
        # √d rounded to the compute dtype before the multiply, as JAX does
        h = h * torch.tensor(math.sqrt(model.cfg.d_model), dtype=h.dtype,
                             device=h.device)
    return constrain(h, "batch", None, None)


def _table(model: Transformer):
    return model.embed if model.unembed is None else model.unembed


def logits_of(model: Transformer, h):
    return constrain(softcap(h @ _table(model).T, model.cfg.final_softcap),
                     "batch", None, "vocab")


# ---------------------------------------------------------------------------
# training forward
# ---------------------------------------------------------------------------
def model_apply(model: Transformer, batch, return_logits=False):
    """Train/eval forward over batch['tokens'] and batch['labels'] (B, S),
    the VLM's batch['patches'] and an encoder–decoder's batch['frames'].

    The VLM's patch prefix gets labels of −1 (ignored); each decoder
    layer of an encoder–decoder attends to the encoder's output through
    its own cross K/V.  Layers are rematerialised by ``cfg.remat``
    (``_run_layers``).  The loss is the chunked cross-entropy of the
    final norm's output against the (tied) unembedding, or, with
    ``return_logits``, the plain one over the full logits.  Returns
    (total, metrics) or (total, metrics, logits): metrics = {"loss", the
    summed aux terms} and total = loss + 0.01·moe_lb + 1e-3·moe_z.  The
    parameters are used as they are stored (the train step hands over a
    cast copy in the compute dtype).
    """
    cfg = model.cfg
    dev = model.device
    tokens = _tokens(batch["tokens"], dev)
    labels = _tokens(batch["labels"], dev)
    B = tokens.shape[0]
    h = embed_tokens(model, tokens)
    if cfg.family == "vlm":
        pe = _project(model, batch["patches"])
        h = torch.cat([pe, h], dim=1)
        labels = torch.cat([torch.full((B, pe.shape[1]), -1,
                                       dtype=labels.dtype, device=dev),
                            labels], dim=1)
    positions = _positions(B, h.shape[1], dev, h)
    if cfg.encoder_decoder:
        enc_out = _encode(model, batch.get("frames"), remat=cfg.remat)
        h, aux = _run_layers(model.layers, h, cfg, positions, enc_out,
                             remat=cfg.remat)
    else:
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        h, aux = _run_layers(model.layers, h, cfg, positions,
                             remat=cfg.remat)
        aux = {"moe_lb": aux.get("moe_lb", zero),
               "moe_z": aux.get("moe_z", zero)}
    h = model.final_norm(h, cfg.norm_eps)
    if return_logits:
        logits = logits_of(model, h)
        loss = cross_entropy(logits, labels)
    else:
        loss = chunked_cross_entropy(h, _table(model), labels, cfg,
                                     chunk=cfg.ce_chunk)
    metrics = {"loss": loss, **aux}
    total = loss + 0.01 * aux.get("moe_lb", 0.0) + 1e-3 * aux.get("moe_z",
                                                                  0.0)
    if return_logits:
        return total, metrics, logits
    return total, metrics


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
    """Full forward over batch['tokens'] (B, S), after the VLM's
    batch['patches'] (B, n_patches, patch_dim) when given, and over an
    encoder–decoder's batch['frames'] (B, S_src, patch_dim).  Returns the
    last position's logits (B, vocab) and the decode state: ``pos`` (St =
    n_patches + S), one cache per layer — KV (a ring buffer for local
    layers) or the RG-LRU's or Mamba's (h, conv window) — and for an
    encoder–decoder ``cross``, each decoder layer's encoder (k, v) in the
    compute dtype.  ``cache_dtype`` defaults to bf16 even for an f32
    model, as in the JAX package.  Raises ValueError when St > ``max_len``
    and the model has a global attention layer."""
    cfg = model.cfg
    h, positions = _embed_input(model, batch["tokens"], batch.get("patches"))
    St = h.shape[1]
    if any(blk.kind == "attn" for blk in model.layers):
        _check_cache_room(0, St, max_len)
    enc_out = (_encode(model, batch.get("frames"))
               if cfg.encoder_decoder else None)
    caches, cross = [], []
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
            if enc_out is not None:
                cross.append(cross_kv(blk.cross, enc_out, cfg))
                h = _cross(blk, h, cfg, cross[-1])
        else:
            y, cache = rglru_prefill(blk.mixer, hn, cfg, cache_dtype)
            h = h + y
        h = h + _post(blk, "post2", _ffn(blk, h, cfg)[0], cfg)
        caches.append(cache)
    h = model.final_norm(h[:, -1:], cfg.norm_eps)
    state = {"pos": St, "layers": caches}
    if cfg.encoder_decoder:
        state["cross"] = cross
    return logits_of(model, h)[:, 0], state


def init_decode_state(cfg, B, max_len, src_len=0, cache_dtype=torch.bfloat16,
                      device=None):
    """Zeroed decode state, one cache per layer in layer order; for an
    encoder–decoder also ``cross``, each layer's (k, v) (B, src_len, K,
    hd), zeros in ``cache_dtype``."""
    dev = resolve_device(device)
    layers = [init_kv_cache(cfg, B, max_len, kind, cache_dtype, device=dev)
              if kind in _ATTN else
              init_mamba_state(cfg, B, cache_dtype, device=dev)
              if kind == "mamba" else
              init_rglru_state(cfg, B, cache_dtype, device=dev)
              for kind in cfg.layer_kinds()]
    state = {"pos": 0, "layers": layers}
    if cfg.encoder_decoder:
        shape = (B, src_len, cfg.n_kv_heads, cfg.head_dim)
        state["cross"] = [
            tuple(torch.zeros(shape, dtype=cache_dtype, device=dev)
                  for _ in range(2)) for _ in range(cfg.n_layers)]
    return state


def block_decode(blk: Block, h, cfg, cache, pos, cross=None):
    """One block, one token; ``cross`` a decoder layer's encoder (k, v).
    Returns (h, the layer's new cache)."""
    hn = blk.norm1(h, cfg.norm_eps)
    if blk.kind == "mamba":
        y, cache = mamba_decode(blk.mixer, hn, cfg, cache)
        return h + y, cache
    if blk.kind in _ATTN:
        y = decode_attention(blk.mixer, hn, cfg, blk.kind, cache, pos)
        h = h + _post(blk, "post1", y, cfg)
        if cross is not None:
            h = h + cross_decode_attention(
                blk.cross, blk.norm_x(h, cfg.norm_eps), cfg, cross)
    else:
        y, cache = rglru_decode(blk.mixer, hn, cfg, cache)
        h = h + y
    return h + _post(blk, "post2", _ffn(blk, h, cfg)[0], cfg), cache


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
    cross = state.get("cross") or [None] * len(model.layers)
    caches = []
    for blk, cache, kv in zip(model.layers, state["layers"], cross):
        h, cache = block_decode(blk, h, cfg, cache, pos, kv)
        caches.append(cache)
    h = model.final_norm(h, cfg.norm_eps)
    new = {"pos": pos + 1, "layers": caches}
    if "cross" in state:
        new["cross"] = state["cross"]
    return logits_of(model, h)[:, 0], new
