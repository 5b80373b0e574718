"""Meta stand-ins for K5 and its backward, for the dry run.

The dry run (``launch/dryrun.py``) traces a program on meta tensors,
where no CUDA kernel can launch.  There ``flash_attention_op`` runs
``MetaFlashAttention``, an autograd Function over two
``torch.library.custom_op``s, ``repro_torch::k5_fwd`` (with the rows'
log-sum-exp, as training calls K5) and ``repro_torch::k5_bwd``, and
serving's ``repro_torch::k5`` (no log-sum-exp).  Their fake (meta)
implementations allocate exactly what ``kernel.flash_attention`` and
``kernel.flash_attention_bwd`` allocate: ``out`` and, in training, the
(B, H, S) f32 log-sum-exp; in the backward dq, dk, dv and the (B, H, S)
f32 D scratch, which ``k5_bwd`` returns as a fourth output so that the
trace's peak sees it.  Nothing else runs: no score tensor exists.

``k5_product_flops`` is the count ``launch/hlo_analysis.py`` gives these
ops: the products the kernels compute, 4·hd a (query, key) pair in the
forward (QKᵀ and PV), 18·hd in the backward (dQ's two passes, 4 + 6;
dK/dV's Sᵀ, dPᵀ, dV and dK, 8), 22·hd on the ``wgmma`` route at width
256 (whose dK/dV consumers each form the whole Sᵀ and dPᵀ), over the
pairs of the tiles the kernels visit: the tile walk of
``csrc/flash_attention.cu`` (blocks of 128 query rows in bf16 and 64 in
f32, 64-key tiles, a tile skipped by a unit of rows, a warpgroup of 64
in bf16 and a warp of 16 in f32, where all of its pairs are masked) and
``kernel.bwd_geometry``'s tiles for the backward (the ``wgmma`` kernels
skip a tile by a warpgroup, the f32-FMA kernels visit every tile of
their range).  hd is the head width; each pair of a visited tile counts,
masked or past the end.

``register_k5_sharding`` gives DTensor the ops' rules, so that on a
mesh each runs locally on a shard: batch-sharded; sharded over heads (q
over H and k/v over K when K divides every mesh axis, else k/v whole:
the count is of the local query heads); or sharded over the query
sequence with k/v whole (the reference's ``seq_mp`` fallback; the
backward's dk/dv are then partial sums).  Only meta tensors take these
ops, so a shard's local call is a count, not a computation, and the
count (``launch/hlo_analysis.py``) gives it its share of the global
call's walk: for a query-sequence shard under a causal mask the mean
over the ranks, not the walk of its own rows from position 0.
"""
from __future__ import annotations

import functools

import torch

from .kernel import bwd_geometry

__all__ = ["MetaFlashAttention", "META_OPS", "k5_meta", "k5_product_flops",
           "register_k5_sharding"]

# flash_attention.cu: (rows a block, rows a unit that skips a tile, keys
# a tile) by value type (Cfg<T>::kWarps·16, kUnitRows, kBKV)
_FWD_TILES = {torch.bfloat16: (128, 64, 64), torch.float32: (64, 16, 64)}
_WG = 64                        # rows (or keys) of a wgmma warpgroup


def _not_on_the_card():
    raise NotImplementedError(
        "the K5 stand-ins run on meta tensors only: the card runs the CUDA "
        "kernels (kernel.py)")


@torch.library.custom_op("repro_torch::k5", mutates_args=())
def _k5(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
        window: int | None, cap: float | None) -> torch.Tensor:
    _not_on_the_card()


@torch.library.custom_op("repro_torch::k5_fwd", mutates_args=())
def _k5_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int | None, cap: float | None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    _not_on_the_card()


@torch.library.custom_op("repro_torch::k5_bwd", mutates_args=())
def _k5_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            dout: torch.Tensor, lse: torch.Tensor, causal: bool,
            window: int | None, cap: float | None
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       torch.Tensor]:
    _not_on_the_card()


def _stats(q):
    """A (B, H, S) f32 tensor beside q (B, S, H, hd): the log-sum-exp, or
    the backward's D scratch."""
    B, S, H, _ = q.shape
    return torch.empty((B, H, S), dtype=torch.float32, device=q.device)


@_k5.register_fake
def _(q, k, v, causal, window, cap):
    return torch.empty_like(q)


@_k5_fwd.register_fake
def _(q, k, v, causal, window, cap):
    return torch.empty_like(q), _stats(q)


@_k5_bwd.register_fake
def _(q, k, v, dout, lse, causal, window, cap):
    return (*(torch.empty_like(t) for t in (q, k, v)), _stats(q))


META_OPS = {torch.ops.repro_torch.k5.default: "fwd",
            torch.ops.repro_torch.k5_fwd.default: "fwd",
            torch.ops.repro_torch.k5_bwd.default: "bwd"}


class MetaFlashAttention(torch.autograd.Function):
    """``ops.FlashAttention`` on meta tensors: the stand-ins in place of
    K5 and its backward, saving what K5's Function saves."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap):
        out, lse = _k5_fwd(q, k, v, causal, window, cap)
        ctx.save_for_backward(q, k, v, lse)
        ctx.opts = (causal, window, cap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv, _ = _k5_bwd(q, k, v, dout.to(q.dtype).contiguous(), lse,
                                *ctx.opts)
        return dq, dk, dv, None, None, None


def k5_meta(q, k, v, causal, window, cap):
    """K5 (with its backward where a gradient is needed) on meta tensors,
    or on DTensors whose shards are on meta."""
    if type(q) is not torch.Tensor:
        register_k5_sharding()
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return MetaFlashAttention.apply(q, k, v, causal, window, cap)
    return _k5(q, k, v, causal, window, cap)


# ---- the count --------------------------------------------------------------
def _rows_masked(r0, rows, k0, keys, S, T, causal, window):
    """True when no (row, key) pair of rows r0 .. r0 + rows − 1 and keys
    k0 .. k0 + keys − 1 is seen, and none of the rows lacks an unmasked
    key (the kernels' tile_masked_for_rows and pairs_closed)."""
    if r0 >= S or k0 >= T:
        return True
    if window and min(r0 + rows, S) - 1 >= T + window - 1:
        return False                    # a key-less row sees every key
    if causal and k0 > r0 + rows - 1:
        return True
    return bool(window) and r0 - (k0 + keys - 1) >= window


def _key_range(q0, rows, S, T, causal, window):
    """The keys that can hold an unmasked key of rows q0 .. q0 + rows − 1
    (the forward's tile_walk): (lo, hi), hi < lo when there are none."""
    q_hi = min(q0 + rows, S) - 1
    hi = min(q_hi, T - 1) if causal else T - 1
    lo = max(0, q0 - window + 1) if window else 0
    return lo, hi


@functools.lru_cache(maxsize=None)
def _query_major(S, T, causal, window, block, unit, keys, all_keys_case):
    """Pairs visited by blocks of ``block`` query rows walking tiles of
    ``keys`` keys, a unit of ``unit`` rows skipping a tile whose pairs
    are all masked (``unit`` = ``block``: no skip)."""
    n = 0
    for q0 in range(0, S, block):
        lo, hi = _key_range(q0, block, S, T, causal, window)
        every = (all_keys_case and bool(window)
                 and min(q0 + block, S) - 1 >= T + window - 1)
        tiles = (range(-(-T // keys)) if every else
                 range(lo // keys, hi // keys + 1) if lo <= hi else ())
        for kt in tiles:
            k0 = kt * keys
            for r0 in range(q0, q0 + block, unit):
                if unit == block or every or not _rows_masked(
                        r0, unit, k0, keys, S, T, causal, window):
                    n += unit * keys
    return n


@functools.lru_cache(maxsize=None)
def _key_major(S, T, causal, window, block, rows, unit):
    """Pairs visited by blocks of ``block`` keys walking tiles of ``rows``
    query rows (dK/dV), a unit of ``unit`` keys skipping a tile whose
    pairs are all masked (``unit`` = ``block``: no skip)."""
    keyless = bool(window) and S - 1 >= T + window - 1
    n = 0
    for k0 in range(0, T, block):
        k_hi = min(k0 + block, T) - 1
        q_lo = k0 if causal else 0
        q_hi = S - 1
        if window and not keyless:
            q_hi = min(q_hi, k_hi + window - 1)
        if q_lo > q_hi:
            continue
        for qt in range(q_lo // rows, q_hi // rows + 1):
            q0 = qt * rows
            for kw in range(k0, k0 + block, unit):
                if unit == block or not _rows_masked(
                        q0, rows, kw, unit, S, T, causal, window):
                    n += rows * unit
    return n


def k5_product_flops(kind, q, k, causal, window):
    """Product flops of one stand-in call (``kind`` "fwd" or "bwd") on q
    (B, S, H, hd), k (B, T, K, hd): see the module docstring."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    if B * H * S * T == 0:
        return 0.0
    window = int(window or 0)
    if kind == "fwd":
        block, unit, keys = _FWD_TILES.get(q.dtype, _FWD_TILES[torch.float32])
        pairs = _query_major(S, T, causal, window, block, unit, keys, True)
        return 4.0 * hd * pairs * B * H
    vec = (hd * q.element_size()) % 16 == 0
    geo = bwd_geometry(B, S, T, H, k.shape[2], hd, q.dtype, vec)
    wgmma = geo.route == "wgmma"
    dq = _query_major(S, T, causal, window, geo.dq_rows,
                      _WG if wgmma else geo.dq_rows, geo.dq_keys, False)
    wide = wgmma and geo.hd_tile == 256     # both consumers on every key
    kv_unit = (geo.dkdv_keys if wide or not wgmma else _WG)
    dkdv = _key_major(S, T, causal, window, geo.dkdv_keys, geo.dkdv_rows,
                      kv_unit)
    return float(hd * B * H * (10 * dq + (12 if wide else 8) * dkdv))


# ---- DTensor rules ----------------------------------------------------------
_REGISTERED: list = []


def register_k5_sharding():
    """Register the stand-ins' DTensor sharding rules (once a process)."""
    if _REGISTERED:
        return
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding

    R, opts = Replicate(), [None, None, None]

    def kv_heads_divide(k):
        return all(k.shape[2] % n == 0 for n in k.mesh.shape)

    def fwd_rules(k, outs):
        """(outputs, q, k, v) of each rule; ``outs`` "out" or "out, lse"."""
        heads_kv = Shard(2) if kv_heads_divide(k) else R
        rules = [((R, R), (R, R, R)),
                 ((Shard(0), Shard(0)), (Shard(0),) * 3),
                 ((Shard(2), Shard(1)), (Shard(2), heads_kv, heads_kv)),
                 ((Shard(1), Shard(2)), (Shard(1), R, R))]
        n = 2 if outs == "out, lse" else 1
        return [(list(o[:n]), list(i) + opts) for o, i in rules]

    @register_sharding(torch.ops.repro_torch.k5.default)
    def _(q, k, v, causal, window, cap):
        return fwd_rules(k, "out")

    @register_sharding(torch.ops.repro_torch.k5_fwd.default)
    def _(q, k, v, causal, window, cap):
        return fwd_rules(k, "out, lse")

    @register_sharding(torch.ops.repro_torch.k5_bwd.default)
    def _(q, k, v, dout, lse, causal, window, cap):
        heads_kv = Shard(2) if kv_heads_divide(k) else R
        heads_dkv = heads_kv if kv_heads_divide(k) else Partial()
        # (dq, dk, dv, dd), (q, k, v, dout, lse)
        rules = [((R,) * 4, (R,) * 5),
                 ((Shard(0),) * 4, (Shard(0),) * 5),
                 ((Shard(2), heads_dkv, heads_dkv, Shard(1)),
                  (Shard(2), heads_kv, heads_kv, Shard(2), Shard(1))),
                 ((Shard(1), Partial(), Partial(), Shard(2)),
                  (Shard(1), R, R, Shard(1), Shard(2)))]
        return [(list(o), list(i) + opts) for o, i in rules]

    _REGISTERED.append(True)
