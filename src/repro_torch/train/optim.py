"""AdamW and its learning-rate schedule on dicts of tensors.

The JAX package's update, step for step (not ``torch.optim.AdamW``):
the global-norm clip, the bias-corrected moments, decoupled weight decay
scaled by the learning rate, and the warm-up + cosine schedule.  The
moments live in f32 whatever the parameter dtype.  Parameters, gradients
and moments are dicts keyed by parameter name (``model.named_parameters``).
``skip``, a device bool, freezes the update through ``torch.where``
without a host read: the NaN guard of the train step.  The update writes
the parameters and moments in place (the JAX package returns new trees)
and returns them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm", "clip_by_global_norm"]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1


class AdamWState(NamedTuple):
    step: torch.Tensor      # () int32 on the parameters' device
    mu: dict
    nu: dict


def adamw_init(params: dict) -> AdamWState:
    """Step 0 and zero f32 moments beside each parameter."""
    dev = next(iter(params.values())).device
    zeros = {k: torch.zeros_like(p, dtype=torch.float32)
             for k, p in params.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=zeros,
                      nu={k: torch.zeros_like(z) for k, z in zeros.items()})


def cosine_schedule(cfg: AdamWConfig, step):
    """Linear warm-up to ``lr`` over ``warmup_steps``, then a cosine down
    to ``min_lr_frac``·lr at ``total_steps``; ``step`` a tensor."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree: dict):
    """√(Σ ‖x‖²) over the dict's tensors, in f32."""
    total = 0
    for x in tree.values():
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


def clip_by_global_norm(grads: dict, max_norm):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
    return {k: g * scale for k, g in grads.items()}, norm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: dict, state: AdamWState,
                 params: dict, skip=None):
    """One AdamW step.  ``skip`` (a bool tensor) freezes the update: a
    poisoned step advances nothing, the step counter included.  Returns
    (params, state, {"grad_norm", "lr"}); params and moments are updated
    in place, leaf by leaf (the clip's scale is applied per leaf, so no
    clipped copy of all gradients exists at once)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp_min(gnorm, 1e-12),
                        max=1.0)
    step = state.step + 1
    lr = cosine_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    sf = step.float()
    c1, c2 = 1 - b1 ** sf, 1 - b2 ** sf
    for k, p in params.items():
        g = (grads[k] * scale).float()
        m, v = state.mu[k], state.nu[k]
        m_n = b1 * m + (1 - b1) * g
        v_n = b2 * v + (1 - b2) * g * g
        mh = m_n / c1
        vh = v_n / c2
        p32 = p.float()
        delta = lr * (mh / (torch.sqrt(vh) + cfg.eps)
                      + cfg.weight_decay * p32)
        p_n = (p32 - delta).to(p.dtype)
        if skip is not None:
            p_n = torch.where(skip, p, p_n)
            m_n = torch.where(skip, m, m_n)
            v_n = torch.where(skip, v, v_n)
        p.copy_(p_n)
        m.copy_(m_n)
        v.copy_(v_n)
    if skip is not None:
        step = torch.where(skip, state.step, step)
    return (params, AdamWState(step=step, mu=state.mu, nu=state.nu),
            {"grad_norm": gnorm, "lr": lr})
