"""Wrapper of the CUDA linear scan kernel (``csrc/linear_scan.cu``).

``linear_scan``  K4 — h_t = a_t ⊙ h_{t−1} + b_t with h_{−1} = 0 over
(B, S, D) inputs, f32 or bf16, the state in f32 and the result in a's
dtype.  The kernel is a chunked scan in one pass: one block per
(chunk of ``CHUNK`` steps, batch row, tile of ``LANES`` channels), the
carry between chunks by decoupled look-back through scratch that this
wrapper allocates (``scan_geometry`` says how much).

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the output and the scratch on the current stream,
launches on it, raises if the launch is refused, and adds one to
``LAUNCHES["linear_scan"]``.  The library is built from the repo's
sources on first use (``kernels/_build.py``).  The plain version lives in
``ref.py``; ``ops.py`` chooses between the two.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .._build import launch

__all__ = ["LAUNCHES", "linear_scan", "reset_launches", "scan_geometry",
           "ScanGeometry", "CHUNK", "LANES"]

# Launches since the last reset, counted where the kernel is launched.
LAUNCHES = {"linear_scan": 0}
# Steps and channels a block owns; csrc/linear_scan.cu's kChunk and
# kLanes, which the kernel checks against what it is passed.
CHUNK = 64
LANES = 128

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P]
_ENTRY = {torch.float32: "linear_scan_f32", torch.bfloat16: "linear_scan_bf16"}


class ScanGeometry(NamedTuple):
    """The launch of one (B, S, D) scan: ``blocks`` = ``n_chunks`` ×
    B × ``n_dtiles``; ``flag_ints`` zeroed ints (the ticket counter and
    one flag a block); ``carry_floats`` f32 scratch (each chunk's
    composite a and b and its inclusive prefix, per lane)."""
    n_chunks: int
    n_dtiles: int
    blocks: int
    flag_ints: int
    carry_floats: int


def scan_geometry(B: int, S: int, D: int) -> ScanGeometry:
    n_chunks = -(-S // CHUNK)
    n_dtiles = -(-D // LANES)
    blocks = n_chunks * B * n_dtiles
    return ScanGeometry(n_chunks, n_dtiles, blocks, 1 + blocks,
                        3 * n_chunks * B * D)


def reset_launches() -> None:
    LAUNCHES["linear_scan"] = 0


def linear_scan(a, b):
    """K4 on the card: a, b (B, S, D) → h (B, S, D) in a's dtype."""
    for name, t in (("a", a), ("b", b)):
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError("the CUDA linear scan kernel takes CUDA "
                             "tensors; use ops.py for CPU tensors")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if a.dtype not in _ENTRY or b.dtype != a.dtype:
        raise TypeError(f"a and b must share one dtype of "
                        f"{sorted(map(str, _ENTRY))}; got {a.dtype}, "
                        f"{b.dtype}")
    if a.ndim != 3 or b.shape != a.shape:
        raise ValueError(f"a and b must be one (B, S, D) shape; got "
                         f"{tuple(a.shape)}, {tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError("a and b lie on different devices")
    B, S, D = a.shape
    geo = scan_geometry(B, S, D)
    y = torch.empty_like(a)
    flags = torch.zeros(geo.flag_ints, dtype=torch.int32, device=a.device)
    carry = torch.empty(geo.carry_floats, dtype=torch.float32,
                        device=a.device)
    launch("linear_scan", _ENTRY[a.dtype], _ARGS, a.device,
           _P(a.data_ptr()), _P(b.data_ptr()), _P(y.data_ptr()),
           _I(B), _I(S), _I(D), _I(CHUNK), _I(LANES),
           _P(flags.data_ptr()), _P(carry.data_ptr()))
    LAUNCHES["linear_scan"] += 1
    return y
