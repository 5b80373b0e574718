"""Dispatch between the CUDA linear scan kernels and their plain versions.

``impl`` as in ``kernels/flash_attention/ops.py``: "cuda" and "auto"
launch the kernel on CUDA tensors (or raise) and run the plain version on
CPU tensors; "ref" runs the plain version wherever the tensors lie.

On CUDA tensors of which one requires a gradient (training), the call
goes through ``LinearScan``, a ``torch.autograd.Function`` whose forward
is K4 (saving a and its output h) and whose backward is K4's backward
kernel.  Serving (no gradient) calls K4 directly.  On CPU tensors
autograd differentiates the plain version, which is also what the
backward kernel is held against.
"""
from __future__ import annotations

import torch

from .._build import use_cuda_for
from .kernel import linear_scan, linear_scan_bwd
from .ref import linear_scan_ref

__all__ = ["linear_scan_op", "linear_scan_ref", "LinearScan"]


class LinearScan(torch.autograd.Function):
    """K4 forward and backward on CUDA tensors.  b is not saved: the
    backward reads a, the output h and its gradient.  Under a
    non-reentrant ``torch.utils.checkpoint`` the forward runs again in
    the backward pass, so a rematerialised layer launches K4 twice a
    step and its backward once."""

    @staticmethod
    def forward(ctx, a, b):
        h = linear_scan(a, b)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, dh):
        a, h = ctx.saved_tensors
        return linear_scan_bwd(a, h, dh.to(a.dtype).contiguous())


def linear_scan_op(a, b, impl="auto"):
    """h_t = a_t h_{t−1} + b_t, h_{−1} = 0, over a, b (B, S, D)."""
    if use_cuda_for(a, impl):
        if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
            return LinearScan.apply(a, b)
        return linear_scan(a, b)
    return linear_scan_ref(a, b)
