"""Elastic reallocation: executing a SmartFill schedule on real jobs.

SmartFill's output is piecewise-constant allocations with changes at job
completions (Prop. 7).  For a training job, an allocation change θ₁ → θ₂
is a concrete protocol:

    1. finish the in-flight step; checkpoint,
    2. tear down the old mesh, build a mesh over θ₂ devices,
    3. restore the checkpoint with the NEW mesh's placements
       (``train/checkpoint.py`` restores any checkpoint onto any mesh),
    4. resume from the same data step (stateless pipeline ⇒ exact).

The same protocol is the node-failure path: a dead host shrinks θ by one
slice and the job restarts on the survivors — elasticity and fault
tolerance are one mechanism.

``ElasticTrainer`` implements the protocol.  One process drives one
device here, so a mesh of one device (``mesh_for_chips(n)`` with one
card) is the one a reallocation can restore onto; the placements of a
larger mesh are resolved and then refused (``NamedSharding.device``),
until a torch.distributed path across GPUs exists (ROADMAP item 9).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..convert import port_param_specs
from ..distributed.sharding import FleetMesh, NamedSharding, set_mesh
from ..train import TrainState, checkpoint as ckpt
from ..train.optim import AdamWState

__all__ = ["ElasticTrainer", "ReallocEvent", "mesh_for_chips"]


def _cards():
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError(
            "mesh_for_chips spans the CUDA cards and none is available; "
            "pass devices=[torch.device('cpu')] to run on the CPU")
    return [torch.device("cuda", i) for i in range(n)]


def mesh_for_chips(n_chips: int, devices=None) -> FleetMesh:
    """Best 2-D (data, model) mesh over min(n_chips, len(devices))
    devices, ``devices`` the CUDA cards by default."""
    devices = list(devices) if devices is not None else _cards()
    n = min(n_chips, len(devices))
    # most-square factorization with model ≤ data
    best = (n, 1)
    for m in range(1, int(np.sqrt(n)) + 1):
        if n % m == 0:
            best = (n // m, m)
    dev_arr = np.empty(n, dtype=object)
    dev_arr[:] = devices[:n]
    return FleetMesh(dev_arr.reshape(best), ("data", "model"))


@dataclasses.dataclass
class ReallocEvent:
    t_wall: float
    old_chips: int
    new_chips: int
    ckpt_path: str
    restore_s: float


class ElasticTrainer:
    """Runs a train loop that honors externally-driven chip reallocation."""

    def __init__(self, cfg, step_builder, ckpt_dir: str):
        self.cfg = cfg
        self.step_builder = step_builder     # (mesh) → step fn
        self.ckpt_dir = ckpt_dir
        self.events: list[ReallocEvent] = []

    def _shardings(self, mesh, tree):
        """A ``NamedSharding`` for each leaf of {"params": model, "opt":
        AdamWState}: the spec ``param_sharding`` gives the same leaf of
        the JAX package's tree, as ``convert.port_param_specs`` carries
        it over (stacked axes dropped, the attention's (H, hd) merged);
        the moments take their parameter's, the step P()."""
        with mesh:
            specs = {name: NamedSharding(mesh, spec) for name, spec in
                     port_param_specs(self.cfg, tree["params"]).items()}
        opt = tree["opt"]
        return {"params": specs,
                "opt": AdamWState(step=NamedSharding(mesh),
                                  mu={k: specs[k] for k in opt.mu},
                                  nu={k: specs[k] for k in opt.nu})}

    def reallocate(self, state: TrainState, old_chips: int, new_chips: int):
        """Checkpoint → new mesh → restore onto its placements.  Returns
        (new_mesh, state), the state's model and moments restored."""
        t0 = time.perf_counter()
        tree = {"params": state.params, "opt": state.opt_state}
        path = ckpt.save(self.ckpt_dir, state.step, tree,
                         {"reason": "realloc", "old": old_chips,
                          "new": new_chips})
        new_mesh = mesh_for_chips(new_chips)
        set_mesh(new_mesh)
        shardings = self._shardings(new_mesh, tree)
        restored, manifest = ckpt.restore(path, tree, shardings=shardings)
        state.params = restored["params"]
        state.opt_state = restored["opt"]
        dt = time.perf_counter() - t0
        self.events.append(ReallocEvent(
            t_wall=dt, old_chips=old_chips, new_chips=new_chips,
            ckpt_path=path, restore_s=dt))
        return new_mesh, state
