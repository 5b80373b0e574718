"""Gated MLPs (SwiGLU / GeGLU)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..distributed.sharding import constrain
from .common import dense_init

__all__ = ["MLP", "mlp_init", "mlp"]


class MLP(nn.Module):
    """w_gate, w_up (d_model, d_ff) and w_down (d_ff, d_model)."""

    def __init__(self, d_model: int, d_ff: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.w_gate = nn.Parameter(torch.empty(d_model, d_ff, **kw))
        self.w_up = nn.Parameter(torch.empty(d_model, d_ff, **kw))
        self.w_down = nn.Parameter(torch.empty(d_ff, d_model, **kw))


def mlp_init(m: MLP, generator) -> MLP:
    d_model, d_ff = m.w_gate.shape
    dense_init(m.w_gate, d_model, generator)
    dense_init(m.w_up, d_model, generator)
    dense_init(m.w_down, d_ff, generator)
    return m


def _act(x, kind):
    # jax.nn.gelu defaults to the tanh approximation; so does the port
    if kind == "geglu":
        return F.gelu(x, approximate="tanh")
    return F.silu(x)


def mlp(m: MLP, x: torch.Tensor, kind: str = "swiglu") -> torch.Tensor:
    g = x @ m.w_gate
    u = x @ m.w_up
    h = constrain(_act(g, kind) * u, "batch", None, "ff")
    # placed as the residual stream, as the JAX package's partitioner
    # places a row-parallel product's output
    return constrain(h @ m.w_down, "batch", None, None)
