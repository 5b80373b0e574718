"""Dispatch between the CUDA linear scan kernel and its plain version.

``impl`` as in ``kernels/flash_attention/ops.py``: "cuda" and "auto"
launch the kernel on CUDA tensors (or raise) and run the plain version on
CPU tensors; "ref" runs the plain version wherever the tensors lie.

K4 has no backward kernel yet (ROADMAP, Queue 1 item 15(a)): on CUDA
tensors that require a gradient the op raises rather than fall back to
the plain scan.  On CPU tensors autograd differentiates the plain version.
"""
from __future__ import annotations

import torch

from .._build import use_cuda_for
from .kernel import linear_scan
from .ref import linear_scan_ref

__all__ = ["linear_scan_op", "linear_scan_ref"]


def linear_scan_op(a, b, impl="auto"):
    """h_t = a_t h_{t−1} + b_t, h_{−1} = 0, over a, b (B, S, D)."""
    if use_cuda_for(a, impl):
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            raise NotImplementedError(
                "the linear scan kernel (K4) has no backward yet (ROADMAP "
                "Queue 1, item 15(a)): training through K4 on the card "
                "waits for it")
        return linear_scan(a, b)
    return linear_scan_ref(a, b)
