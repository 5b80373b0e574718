"""Dispatch between the CUDA flash attention kernel and its plain version.

``impl`` keeps the JAX package's contract with "cuda" in place of
"pallas"/"interpret", as ``kernels/gwf_waterfill/ops.py`` does:

  * "cuda" on CUDA tensors launches the kernel (or raises); on CPU
    tensors it runs the plain version;
  * "ref" runs the plain version wherever the tensors lie;
  * "auto" launches the kernel on CUDA tensors and runs the plain
    version on CPU tensors only.
"""
from __future__ import annotations

from .._build import use_cuda_for
from .kernel import flash_attention
from .ref import attention_ref

__all__ = ["flash_attention_op", "attention_ref"]


def flash_attention_op(q, k, v, causal=True, window=None, cap=None,
                       impl="auto"):
    """Attention over pre-scaled q (B, S, H, hd) and k/v (B, T, K, hd)."""
    if use_cuda_for(q, impl):
        return flash_attention(q, k, v, causal=causal, window=window, cap=cap)
    return attention_ref(q, k, v, causal=causal, window=window, cap=cap)
