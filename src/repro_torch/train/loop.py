"""Train step and loop: micro-batch gradient accumulation, the NaN guard,
metrics.

``make_train_step`` builds step(model, opt_state, batch) → (model,
opt_state, metrics).  The model holds the f32 masters (built with
``trainable=True``).  The step runs forward and backward on a cast copy:
a second model of the same config whose every parameter is the master
cast to ``cfg.dtype`` (the JAX package's one-shot cast before the layer
stack, norm scales, the MoE router, ``lam`` and ``A_log`` included).  A
master's gradient is its copy's gradient in f32, which is what
differentiating through the cast gives (the JAX package's transpose of
``astype``).  The copy is a module of its own, not parameters swapped in
for the call, because remat recomputes each layer in the backward pass
from the module's parameters.  On the card the forward's attention is
K5 and its backward K5's backward kernel
(``kernels/flash_attention/ops.py``).
"""
from __future__ import annotations

import copy as copy_module
import time
from typing import Callable

import torch

from ..distributed.sharding import constrain
from ..models.transformer import model_apply
from .optim import AdamWConfig, AdamWState, adamw_init, adamw_update

__all__ = ["make_train_step", "train_loop", "TrainState", "loss_and_grads",
           "cast_copy"]


def cast_copy(model):
    """A trainable model of ``model.cfg`` whose every f32 parameter is
    ``model``'s cast to the compute dtype (other dtypes kept), or
    ``model`` itself when the compute dtype is f32: a copy of the module
    tree around the cast parameters, which allocates nothing else (a
    ``DTensor`` master gives a cast ``DTensor`` of its placements)."""
    cfg = model.cfg
    if cfg.dtype == "float32":
        return model
    cast = cfg.compute_dtype
    with torch.no_grad():
        memo = {id(p): torch.nn.Parameter(p.detach().to(
            cast if p.dtype == torch.float32 else p.dtype, copy=True))
            for p in model.parameters()}
    return copy_module.deepcopy(model, memo)


def loss_and_grads(model, batch):
    """(total, metrics, gradients) of ``model_apply`` on ``batch`` run on
    ``cast_copy(model)``; the gradients are f32, keyed by parameter name
    (zeros for a parameter the loss does not reach).  A ``DTensor``
    parameter's gradient is reduced to the parameter's placement once
    here, as the JAX package's partitioner gives a gradient its
    parameter's sharding."""
    run = cast_copy(model)
    params = dict(run.named_parameters())
    total, metrics = model_apply(run, batch)
    gs = torch.autograd.grad(total, list(params.values()), allow_unused=True)
    grads = {n: torch.zeros_like(p, dtype=torch.float32) if g is None
             else _placed_as(g, p).float()
             for (n, p), g in zip(params.items(), gs)}
    return total.detach(), {k: v.detach() for k, v in metrics.items()}, grads


def _placed_as(g, p):
    """``g`` in ``p``'s placement where both are DTensors, else ``g``."""
    if hasattr(g, "device_mesh") and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def _slice(batch, i, n):
    """Micro-slice i of n along the batch axis of every entry."""
    out = {}
    for k, x in batch.items():
        B = x.shape[0]
        if B % n:
            raise ValueError(f"batch[{k!r}] has {B} rows, not a multiple of "
                             f"{n} micro-batches")
        m = B // n
        out[k] = x[i * m:(i + 1) * m]
    return out


def make_train_step(cfg, opt_cfg: AdamWConfig, microbatches: int = 1,
                    compression=None) -> Callable:
    """Build train_step(model, opt_state, batch) → (model, opt_state,
    metrics).

    ``microbatches`` > 1 averages the gradients (and losses) of that many
    equal slices of the batch, one forward and backward each; the
    metrics of the model are the last slice's, as the JAX package's.
    ``compression`` (``distributed/compression.py``) maps the gradient
    dict before the update.  A step whose loss or any gradient is not
    finite updates nothing (``skipped`` = 1).  Metrics are 0-d tensors on
    the model's device: ``loss`` (the total, aux terms included),
    ``moe_lb``/``moe_z`` where the stack has them, ``grad_norm``, ``lr``,
    ``skipped``.
    """
    def step(model, opt_state: AdamWState, batch):
        if model.cfg != cfg:
            raise ValueError("the model's config is not the step's")
        params = dict(model.named_parameters())
        batch = {k: constrain(x, "batch", None, None)
                 for k, x in batch.items()}
        loss = torch.zeros((), dtype=torch.float32, device=model.device)
        grads = None
        for i in range(microbatches):
            mb = batch if microbatches == 1 else _slice(batch, i,
                                                        microbatches)
            total, metrics, gs = loss_and_grads(model, mb)
            if grads is None:
                grads = gs
            else:
                for n, g in gs.items():
                    grads[n].add_(g)
            loss = loss + total.float()
            del gs
        if microbatches > 1:
            loss = loss / microbatches
            for g in grads.values():
                g.div_(microbatches)
        if compression is not None:
            grads = compression(grads)
        # the NaN guard: a poisoned step advances nothing
        bad = ~torch.isfinite(loss)
        for g in grads.values():
            bad = bad | ~torch.isfinite(g).all()
        _, opt_state, opt_metrics = adamw_update(opt_cfg, grads, opt_state,
                                                 params, skip=bad)
        metrics = {**metrics, **opt_metrics, "loss": loss,
                   "skipped": bad.float()}
        return model, opt_state, metrics

    return step


class TrainState:
    """Host-side training state: the model (f32 masters), the optimizer
    state and the step."""

    def __init__(self, params, opt_state, step: int = 0):
        self.params = params
        self.opt_state = opt_state
        self.step = step

    @classmethod
    def create(cls, model):
        return cls(model, adamw_init(dict(model.named_parameters())), 0)


def train_loop(cfg, opt_cfg, state: TrainState, data_iter, n_steps,
               train_step=None, hooks=(), log_every: int = 10):
    """Run ``n_steps``; hooks(step, metrics, state) fire after each step
    (checkpoints, heartbeats).  Each step's metrics are read to the host
    (one synchronisation a step), with ``step_time_s`` the host time of
    the step including that read.  Returns the metrics of every step."""
    step_fn = train_step or make_train_step(cfg, opt_cfg)
    history = []
    for _ in range(n_steps):
        batch = next(data_iter)
        t0 = time.perf_counter()
        state.params, state.opt_state, metrics = step_fn(
            state.params, state.opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        metrics["step_time_s"] = time.perf_counter() - t0
        state.step += 1
        history.append(metrics)
        for hook in hooks:
            hook(state.step, metrics, state)
        if log_every and state.step % log_every == 0:
            print(f"step {state.step}: loss={metrics['loss']:.4f} "
                  f"gnorm={metrics.get('grad_norm', 0):.3f} "
                  f"({metrics['step_time_s']*1e3:.0f} ms)")
    return history
