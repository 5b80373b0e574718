"""Wrapper of the CUDA linear scan kernel (``csrc/linear_scan.cu``).

``linear_scan``  K4 — h_t = a_t ⊙ h_{t−1} + b_t with h_{−1} = 0 over
(B, S, D) inputs, f32 or bf16, the state in f32 and the result in a's
dtype.

The wrapper takes CUDA tensors only: it checks device, dtype, shape and
contiguity, allocates the output with ``torch.empty``, launches on the
current stream, raises if the launch is refused, and adds one to
``LAUNCHES["linear_scan"]``.  The library is built from the repo's
sources on first use (``kernels/_build.py``).  The plain version lives in
``ref.py``; ``ops.py`` chooses between the two.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import launch

__all__ = ["LAUNCHES", "linear_scan", "reset_launches"]

# Launches since the last reset, counted where the kernel is launched.
LAUNCHES = {"linear_scan": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGS = [_P, _P, _P, _I, _I, _I]
_ENTRY = {torch.float32: "linear_scan_f32", torch.bfloat16: "linear_scan_bf16"}


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
    y = torch.empty_like(a)
    launch("linear_scan", _ENTRY[a.dtype], _ARGS, a.device,
           _P(a.data_ptr()), _P(b.data_ptr()), _P(y.data_ptr()),
           _I(B), _I(S), _I(D))
    LAUNCHES["linear_scan"] += 1
    return y
