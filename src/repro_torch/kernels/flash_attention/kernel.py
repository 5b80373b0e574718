"""Wrapper of the CUDA flash attention kernel (``csrc/flash_attention.cu``).

``flash_attention``  K5 — forward online-softmax attention over pre-scaled
q (B, S, H, hd) and k/v (B, T, K, hd), H a multiple of K (query head h
reads kv head h // (H/K)), with a causal mask, a sliding window and a
logit softcap; hd ≤ 256; f32 or bf16 in, q's dtype out, f32 inside.
bf16 runs both products on the tensor cores (``wgmma``); f32 keeps
exact f32 FMAs.  With ``return_lse`` it also returns each row's f32
log-sum-exp (B, H, S), which training saves for the backward.

``flash_attention_bwd``  K5's backward (``csrc/flash_attention_bwd.cu``):
dq, dk, dv from q, k, v, the forward's log-sum-exp and the output's
gradient, f32 inside, the inputs' dtype out; deterministic (no
atomics).  ``bwd_geometry`` routes a call by its shape, and passes the
route, the tiles, the grids and the shared memory to the kernels:

  * bf16 with rows of whole 16-byte pieces and 16-byte-aligned tensors
    (``copies_16_bytes``): the ``wgmma`` kernels, every product on the
    tensor cores, tiles copied by TMA, on the instantiation of 64, 128
    or 256 columns (at 256 with tiles of their own: ``_WGMMA_TILES``);
  * f32, and rows that are not whole 16-byte pieces: the f32-FMA
    kernels.

The route is decided by shape alone: a launch that the card refuses
raises, whatever the route.  ``ops.py`` puts the backward behind a
``torch.autograd.Function``.

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the output with ``torch.empty``, launches on the
current stream, raises if the launch is refused, and adds one to
``LAUNCHES["flash_attention"]`` (the backward
``LAUNCHES["flash_attention_bwd"]``, once a call of its two kernels).
The library is built from the repo's sources on first use
(``kernels/_build.py``).  The plain version lives in ``ref.py``;
``ops.py`` chooses between the two.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .._build import launch

__all__ = ["LAUNCHES", "flash_attention", "flash_attention_bwd",
           "reset_launches", "MAX_HEAD_DIM", "copies_16_bytes",
           "BwdGeometry", "bwd_geometry", "WGMMA_MAX_HEAD_DIM",
           "WGMMA_STAGES", "SMEM_LIMIT", "ONE_BLOCK_SMEM"]

# Launches since the last reset, counted where the kernel is launched.
LAUNCHES = {"flash_attention": 0, "flash_attention_bwd": 0}
MAX_HEAD_DIM = 256

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
         ctypes.c_float, _I]
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_BWD_ARGS = [_P] * 9 + [_I] * 8 + [ctypes.c_float] + [_I] * 14
_BWD_ENTRY = {torch.float32: "flash_attention_bwd_f32",
              torch.bfloat16: "flash_attention_bwd_bf16"}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def copies_16_bytes(hd, element_size, *tensors) -> bool:
    """True when the kernel may copy rows in 16-byte pieces: a row of hd
    elements is whole 16-byte pieces and every tensor starts 16-byte
    aligned.  Otherwise it copies element by element."""
    return (hd * element_size) % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in tensors)


# The backward's geometry.  The wgmma kernels: a block of three
# warpgroups (two consumers, one producer), 128 query rows a dQ block
# over streamed tiles of 64 keys, 128 keys a dK/dV block over streamed
# tiles of 64 query rows, rings of WGMMA_STAGES stages; at hd 256 tiles
# of 32 keys in a ring of 3 stages, and 64 keys a dK/dV block in a ring
# of 2 (``_WGMMA_TILES``).  The FMA kernels: 256 threads, tiles by
# width.  csrc/flash_attention_bwd.cu checks what it is passed against
# its instantiations and refuses a mismatch.
WGMMA_MAX_HEAD_DIM = 256
SMEM_LIMIT = 232_448            # dynamic shared memory a block may use
# At least half of an SM's 233,472 bytes less the 1 KB it keeps for each
# block, so that one wgmma block holds an SM: setmaxnreg then finds the
# registers it moves from the producer to the consumers.
ONE_BLOCK_SMEM = 116 * 1024
_ALIGN_SLACK = 1024             # the 128-byte swizzle repeats every 1 KB
_FMA_TILES = {64: (64, 64), 128: (64, 32), 256: (32, 16)}  # hd: (BQ, BK)
WGMMA_STAGES = 4                # the rings' stages (kStages) at hd ≤ 128
# hd_tile: (dq_rows, dq_keys, dkdv_keys, dkdv_rows, the dQ kernel's
# stages, the dK/dV kernel's); the geometry's ``stages`` is the dQ
# kernel's, ``dkdv_smem`` holds the dK/dV kernel's ring
_WGMMA_TILES = {64: (128, 64, 128, 64, WGMMA_STAGES, WGMMA_STAGES),
                128: (128, 64, 128, 64, WGMMA_STAGES, WGMMA_STAGES),
                256: (128, 32, 64, 64, 3, 2)}


class BwdGeometry(NamedTuple):
    """One backward call's launch, in the order of the C entry's
    arguments: ``route`` "wgmma" or "fma"; ``hd_tile`` the instantiation's
    width; a dQ block owns ``dq_rows`` query rows and walks tiles of
    ``dq_keys`` keys, a dK/dV block owns ``dkdv_keys`` keys and walks
    tiles of ``dkdv_rows`` query rows, through ``stages`` buffers (the
    dQ kernel's ring, which at hd 256 is deeper than the dK/dV
    kernel's), with ``threads`` threads; ``n_qt`` dQ blocks along S and
    ``n_kt`` dK/dV blocks along T, ``dq_blocks`` and ``dkdv_blocks`` in
    all (× heads × batch); ``dq_smem`` and ``dkdv_smem`` bytes of
    dynamic shared memory."""
    route: str
    hd_tile: int
    dq_rows: int
    dq_keys: int
    dkdv_keys: int
    dkdv_rows: int
    stages: int
    threads: int
    n_qt: int
    n_kt: int
    dq_blocks: int
    dkdv_blocks: int
    dq_smem: int
    dkdv_smem: int


def bwd_geometry(B: int, S: int, T: int, H: int, K: int, hd: int, dtype,
                 vec: bool) -> BwdGeometry:
    """The route, tiles, grids and shared memory of K5's backward on q
    (B, S, H, hd) and k/v (B, T, K, hd) of ``dtype``; ``vec``: rows of
    whole 16-byte pieces and 16-byte-aligned tensors
    (``copies_16_bytes``)."""
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} outside 1..{MAX_HEAD_DIM}")
    hd_tile = 64 if hd <= 64 else 128 if hd <= 128 else 256
    if dtype == torch.bfloat16 and vec and hd <= WGMMA_MAX_HEAD_DIM:
        (dq_rows, dq_keys, dkdv_keys, dkdv_rows, stages,
         dkdv_stages) = _WGMMA_TILES[hd_tile]
        threads = 384

        def tile(rows):                 # bytes of a bf16 tile
            return rows * hd_tile * 2
        dq_smem = (_ALIGN_SLACK + 2 * tile(dq_rows)
                   + stages * 2 * tile(dq_keys))
        dkdv_smem = (_ALIGN_SLACK + 2 * tile(dkdv_keys) + dkdv_stages
                     * (2 * tile(dkdv_rows) + 2 * dkdv_rows * 4))
        dq_smem = max(dq_smem, ONE_BLOCK_SMEM)
        dkdv_smem = max(dkdv_smem, ONE_BLOCK_SMEM)
        route = "wgmma"
    else:
        bq, bk = _FMA_TILES[hd_tile]
        dq_rows, dq_keys, dkdv_keys, dkdv_rows = bq, bk, bk, bq
        stages, threads = 1, 256
        ld = hd_tile + 1                # f32 rows padded by one word
        dq_smem = 4 * (2 * bq * ld + 2 * bk * ld + bq * (bk + 1) + 2 * bq)
        dkdv_smem = 4 * (2 * bk * ld + 2 * bq * ld + 2 * bq * (bk + 1)
                         + 2 * bq)
        route = "fma"
    n_qt = -(-S // dq_rows)
    n_kt = -(-T // dkdv_keys)
    return BwdGeometry(route, hd_tile, dq_rows, dq_keys, dkdv_keys,
                       dkdv_rows, stages, threads, n_qt, n_kt,
                       n_qt * H * B, n_kt * K * B, dq_smem, dkdv_smem)


def _check(q, k, v, window, cap, **more):
    """Device, dtype, shape and contiguity of K5's inputs (and of the
    backward's ``more``, each shaped as q): (B, S, H, hd, T, K)."""
    for name, t in (("q", q), ("k", k), ("v", v), *more.items()):
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError("the CUDA flash attention kernel takes CUDA "
                             "tensors; use ops.py for CPU tensors")
        if t.ndim != 4:
            raise ValueError(f"{name} must be 4-d, got {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share one dtype of "
                        f"{sorted(map(str, _ENTRY))}; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v lie on different devices")
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape != (B, T, K, hd) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} "
                         f"do not match q {tuple(q.shape)}")
    if K == 0 or H % K:
        raise ValueError(f"{H} query heads are not a multiple of {K} kv heads")
    if not 0 < hd <= MAX_HEAD_DIM:
        raise ValueError(f"head_dim {hd} outside 1..{MAX_HEAD_DIM}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    if cap is not None and cap <= 0:
        raise ValueError(f"cap must be positive, got {cap}")
    for name, t in more.items():
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name} {tuple(t.shape)} {t.dtype} does not "
                             f"match q {tuple(q.shape)} {q.dtype}")
    return B, S, H, hd, T, K


def _opts(causal, window, cap):
    return (_I(int(bool(causal))), _I(int(window or 0)),
            ctypes.c_float(float(cap or 0.0)))


def flash_attention(q, k, v, *, causal=True, window=None, cap=None,
                    return_lse=False):
    """K5 on the card: q (B, S, H, hd), k/v (B, T, K, hd) → (B, S, H, hd),
    and with ``return_lse`` also the rows' f32 log-sum-exp (B, H, S)."""
    B, S, H, hd, T, K = _check(q, k, v, window, cap)
    out = torch.empty_like(q)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if return_lse else None)
    vec = copies_16_bytes(hd, q.element_size(), q, k, v, out)
    launch("flash_attention", _ENTRY[q.dtype], _ARGS, q.device,
           _P(q.data_ptr()), _P(k.data_ptr()), _P(v.data_ptr()),
           _P(out.data_ptr()), _P(None if lse is None else lse.data_ptr()),
           _I(B), _I(S), _I(T), _I(H), _I(K), _I(hd),
           *_opts(causal, window, cap), _I(int(vec)))
    LAUNCHES["flash_attention"] += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd(q, k, v, dout, lse, *, causal=True, window=None,
                        cap=None):
    """K5's backward on the card: (dq, dk, dv) shaped and typed as q, k, v
    from the forward's row log-sum-exp ``lse`` and the output's gradient
    ``dout``."""
    B, S, H, hd, T, K = _check(q, k, v, window, cap, dout=dout)
    if (not isinstance(lse, torch.Tensor) or lse.device != q.device
            or lse.dtype != torch.float32 or lse.shape != (B, H, S)
            or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous f32 (B, H, S) = "
                         f"{(B, H, S)} tensor on {q.device}")
    if q.numel() == 0:                    # no rows: nothing flows back
        return tuple(torch.zeros_like(t) for t in (q, k, v))
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dd = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    geo = bwd_geometry(B, S, T, H, K, hd, q.dtype, copies_16_bytes(
        hd, q.element_size(), q, k, v, dout, dq, dk, dv))
    if max(geo.dq_blocks, geo.dkdv_blocks) >= 2 ** 31:
        raise ValueError(f"K5's backward grid {geo.dq_blocks}, "
                         f"{geo.dkdv_blocks} blocks is past 2**31 - 1")
    launch("flash_attention_bwd", _BWD_ENTRY[q.dtype], _BWD_ARGS, q.device,
           *(_P(t.data_ptr()) for t in (q, k, v, dout, lse, dd, dq, dk, dv)),
           _I(B), _I(S), _I(T), _I(H), _I(K), _I(hd),
           *_opts(causal, window, cap), _I(int(geo.route == "wgmma")),
           *(_I(x) for x in geo[1:]))
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv
