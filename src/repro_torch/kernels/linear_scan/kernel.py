"""Wrappers of the CUDA linear scan kernels (``csrc/linear_scan.cu``,
``csrc/linear_scan_bwd.cu``).

``linear_scan``  K4 — h_t = a_t ⊙ h_{t−1} + b_t with h_{−1} = 0 over
(B, S, D) inputs, f32 or bf16, the state in f32 and the result in a's
dtype.  The kernel is a chunked scan in one pass: one block per
(chunk of ``CHUNK`` steps, batch row, tile of ``LANES`` channels), the
carry between chunks by decoupled look-back through scratch that this
wrapper allocates (``scan_geometry`` says how much).

``linear_scan_bwd``  K4's backward — from a, the forward's output h and
the output's gradient dh: g_t = dh_t + a_{t+1} ⊙ g_{t+1}, db = g,
da_t = g_t ⊙ h_{t−1} (h_{−1} = 0), in f32 inside and the inputs' dtype
out.  The same one-pass design run from the last chunk back, one block
per (chunk of ``BWD_CHUNK`` steps, batch row, tile of ``LANES``
channels); ``scan_bwd_geometry`` sizes its scratch.

Each wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the outputs and the scratch on the current stream,
launches on it, raises if the launch is refused, and adds one to
``LAUNCHES["linear_scan"]`` (the backward to
``LAUNCHES["linear_scan_bwd"]``).  The libraries are built from the
repo's sources on first use (``kernels/_build.py``).  The plain versions
live in ``ref.py``; ``ops.py`` chooses between kernel and plain.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .._build import launch

__all__ = ["LAUNCHES", "linear_scan", "linear_scan_bwd", "reset_launches",
           "scan_geometry", "scan_bwd_geometry", "ScanGeometry", "CHUNK",
           "BWD_CHUNK", "LANES"]

# Launches since the last reset, counted where the kernel is launched.
LAUNCHES = {"linear_scan": 0, "linear_scan_bwd": 0}
# Steps and channels a block owns; csrc/linear_scan.cu's kChunk and
# kLanes (linear_scan_bwd.cu's kChunk is BWD_CHUNK: its block holds three
# arrays of a chunk, not two), which the kernels check against what they
# are passed.
CHUNK = 64
BWD_CHUNK = 32
LANES = 128

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P]
_ENTRY = {torch.float32: "linear_scan_f32", torch.bfloat16: "linear_scan_bf16"}
_BWD_ARGS = [_P] * 5 + [_I] * 5 + [_P, _P]
_BWD_ENTRY = {torch.float32: "linear_scan_bwd_f32",
              torch.bfloat16: "linear_scan_bwd_bf16"}


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


def scan_geometry(B: int, S: int, D: int, chunk: int = CHUNK
                  ) -> ScanGeometry:
    n_chunks = -(-S // chunk)
    n_dtiles = -(-D // LANES)
    blocks = n_chunks * B * n_dtiles
    return ScanGeometry(n_chunks, n_dtiles, blocks, 1 + blocks,
                        3 * n_chunks * B * D)


def scan_bwd_geometry(B: int, S: int, D: int) -> ScanGeometry:
    """The backward's launch: ``scan_geometry`` at ``BWD_CHUNK`` steps a
    block, its chunks ticketed last first."""
    return scan_geometry(B, S, D, BWD_CHUNK)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(what, **tensors):
    """The wrappers' checks: CUDA, contiguous, one dtype of ``_ENTRY``,
    one (B, S, D) shape, one device."""
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor) or not t.is_cuda:
            raise ValueError(f"the CUDA linear scan {what} takes CUDA "
                             "tensors; use ops.py for CPU tensors")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    names = ", ".join(tensors)
    ts = list(tensors.values())
    first = ts[0]
    if first.dtype not in _ENTRY or any(t.dtype != first.dtype for t in ts):
        raise TypeError(f"{names} must share one dtype of "
                        f"{sorted(map(str, _ENTRY))}; got "
                        f"{', '.join(str(t.dtype) for t in ts)}")
    if first.ndim != 3 or any(t.shape != first.shape for t in ts):
        raise ValueError(f"{names} must be one (B, S, D) shape; got "
                         f"{', '.join(str(tuple(t.shape)) for t in ts)}")
    if any(t.device != first.device for t in ts):
        raise ValueError(f"{names} lie on different devices")


def _scratch(geo, device):
    return (torch.zeros(geo.flag_ints, dtype=torch.int32, device=device),
            torch.empty(geo.carry_floats, dtype=torch.float32,
                        device=device))


def linear_scan(a, b):
    """K4 on the card: a, b (B, S, D) → h (B, S, D) in a's dtype."""
    _check("kernel", a=a, b=b)
    B, S, D = a.shape
    y = torch.empty_like(a)
    flags, carry = _scratch(scan_geometry(B, S, D), a.device)
    launch("linear_scan", _ENTRY[a.dtype], _ARGS, a.device,
           _P(a.data_ptr()), _P(b.data_ptr()), _P(y.data_ptr()),
           _I(B), _I(S), _I(D), _I(CHUNK), _I(LANES),
           _P(flags.data_ptr()), _P(carry.data_ptr()))
    LAUNCHES["linear_scan"] += 1
    return y


def linear_scan_bwd(a, h, dh):
    """K4's backward on the card: a, h = K4(a, b) and dh, each (B, S, D)
    → (da, db) in a's dtype."""
    _check("backward kernel", a=a, h=h, dh=dh)
    B, S, D = a.shape
    da, db = torch.empty_like(a), torch.empty_like(a)
    flags, carry = _scratch(scan_bwd_geometry(B, S, D), a.device)
    launch("linear_scan_bwd", _BWD_ENTRY[a.dtype], _BWD_ARGS, a.device,
           _P(a.data_ptr()), _P(h.data_ptr()), _P(dh.data_ptr()),
           _P(da.data_ptr()), _P(db.data_ptr()),
           _I(B), _I(S), _I(D), _I(BWD_CHUNK), _I(LANES),
           _P(flags.data_ptr()), _P(carry.data_ptr()))
    LAUNCHES["linear_scan_bwd"] += 1
    return da, db
