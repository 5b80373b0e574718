"""Dispatch between the CUDA flash attention kernels and their plain
version.

``impl`` keeps the JAX package's contract with "cuda" in place of
"pallas"/"interpret", as ``kernels/gwf_waterfill/ops.py`` does:

  * "cuda" on CUDA tensors launches the kernel (or raises); on CPU
    tensors it runs the plain version;
  * "ref" runs the plain version wherever the tensors lie;
  * "auto" launches the kernel on CUDA tensors and runs the plain
    version on CPU tensors only.

On CUDA tensors of which one requires a gradient (training), the call
goes through ``FlashAttention``, a ``torch.autograd.Function`` whose
forward is K5 (saving its inputs and row log-sum-exp) and whose backward
is K5's backward kernel.  On CPU tensors autograd differentiates the
plain version, which is also what the backward kernel is held against.
On meta tensors (the dry run; a DTensor whose shards are on meta too)
the call goes through the kernels' stand-ins (``meta.py``), which
allocate what the kernels allocate and nothing else.
"""
from __future__ import annotations

import torch

from .._build import use_cuda_for
from .kernel import flash_attention, flash_attention_bwd
from .meta import k5_meta
from .ref import attention_ref

__all__ = ["flash_attention_op", "attention_ref", "FlashAttention"]


class FlashAttention(torch.autograd.Function):
    """K5 forward and backward on CUDA tensors.  Under a non-reentrant
    ``torch.utils.checkpoint`` the forward runs again in the backward
    pass, so a rematerialised layer launches K5 twice a step."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, cap):
        out, lse = flash_attention(q, k, v, causal=causal, window=window,
                                   cap=cap, return_lse=True)
        ctx.save_for_backward(q, k, v, lse)
        ctx.opts = dict(causal=causal, window=window, cap=cap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v,
                                         dout.to(q.dtype).contiguous(), lse,
                                         **ctx.opts)
        return dq, dk, dv, None, None, None


def flash_attention_op(q, k, v, causal=True, window=None, cap=None,
                       impl="auto"):
    """Attention over pre-scaled q (B, S, H, hd) and k/v (B, T, K, hd)."""
    if use_cuda_for(q, impl):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttention.apply(q, k, v, causal, window, cap)
        return flash_attention(q, k, v, causal=causal, window=window, cap=cap)
    if q.device.type == "meta" and impl != "ref":
        return k5_meta(q, k, v, causal, window, cap)
    return attention_ref(q, k, v, causal=causal, window=window, cap=cap)
