"""Fault-tolerance substrate of the train loop.

Layers (each usable alone):
  * the in-step NaN/Inf guard lives in the train step (``optim.adamw_update``
    ``skip``): a poisoned gradient advances nothing;
  * ``RetryableStep`` wraps a train step: on a ``RuntimeError`` (which
    covers CUDA errors raised by PyTorch) it restores the latest
    checkpoint and returns, so the caller replays from there; the data
    pipeline is stateless in the step index, so the replay is exact;
  * ``HeartbeatMonitor`` keeps per-host step heartbeats and flags hosts
    silent past a deadline (stragglers, dead hosts);
  * ``CheckpointHook`` writes periodic checkpoints (``checkpoint.py``).
"""
from __future__ import annotations

import os
import shutil
import time

from . import checkpoint as ckpt

__all__ = ["CheckpointHook", "HeartbeatMonitor", "RetryableStep"]


class CheckpointHook:
    def __init__(self, ckpt_dir: str, every: int = 100, keep: int = 3,
                 asynchronous: bool = True):
        self.dir = ckpt_dir
        self.every = every
        self.keep = keep
        self.asynchronous = asynchronous

    def __call__(self, step, metrics, state):
        if step % self.every:
            return
        tree = {"params": state.params, "opt": state.opt_state}
        extra = {"step": step, "loss": metrics.get("loss")}
        if self.asynchronous:
            ckpt.save_async(self.dir, step, tree, extra)
        else:
            ckpt.save(self.dir, step, tree, extra)
        self._gc()

    def _gc(self):
        if not os.path.isdir(self.dir):
            return
        steps = sorted(d for d in os.listdir(self.dir)
                       if d.startswith("step_") and not d.endswith(".tmp"))
        for d in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)


class HeartbeatMonitor:
    """Per-host step heartbeats; flags stragglers past a deadline.

    deadline_factor: a host is a straggler when it has been silent for
    more than factor × the fleet's median inter-step time.  ``host_id``
    defaults to this process's rank in ``torch.distributed`` (0 without
    a process group).
    """

    def __init__(self, n_hosts: int = 1, deadline_factor: float = 3.0,
                 host_id: int | None = None):
        if host_id is None:
            import torch.distributed as dist
            host_id = (dist.get_rank() if dist.is_available()
                       and dist.is_initialized() else 0)
        self.n_hosts = n_hosts
        self.factor = deadline_factor
        self.host_id = host_id
        self.last_beat = {h: time.monotonic() for h in range(n_hosts)}
        self.intervals = {h: [] for h in range(n_hosts)}

    def beat(self, host: int | None = None):
        h = self.host_id if host is None else host
        now = time.monotonic()
        self.intervals[h].append(now - self.last_beat[h])
        self.last_beat[h] = now

    def stragglers(self) -> list[int]:
        meds = []
        for h in range(self.n_hosts):
            iv = self.intervals[h][-16:]
            if iv:
                meds.append(sorted(iv)[len(iv) // 2])
        if not meds:
            return []
        fleet_med = sorted(meds)[len(meds) // 2]
        now = time.monotonic()
        return [h for h in range(self.n_hosts)
                if now - self.last_beat[h] > self.factor * max(fleet_med,
                                                               1e-3)]

    def __call__(self, step, metrics, state):
        self.beat()


class RetryableStep:
    """Wraps a train step with checkpoint-restore on a runtime error.

    ``__call__(state, batch)`` returns ((model, opt_state, metrics), the
    next step) on success.  On a ``RuntimeError`` it restores the latest
    checkpoint into ``state`` (the model's parameters in place) and
    returns (None, the restored step), so the caller fetches that step's
    batch and replays; after ``max_retries`` consecutive failures it
    re-raises.  (The reference's ``template`` argument is unused there
    too: the restore's template is the state's own tree.)
    """

    def __init__(self, step_fn, ckpt_dir: str, max_retries: int = 3):
        self.step_fn = step_fn
        self.ckpt_dir = ckpt_dir
        self.max_retries = max_retries
        self.failures = 0

    def __call__(self, state, batch):
        try:
            out = self.step_fn(state.params, state.opt_state, batch)
            self.failures = 0
            return out, state.step + 1
        except RuntimeError as e:
            self.failures += 1
            if self.failures > self.max_retries:
                raise
            path = ckpt.latest(self.ckpt_dir)
            if path is None:
                raise RuntimeError("step failed with no checkpoint") from e
            tree, manifest = ckpt.restore(
                path, {"params": state.params, "opt": state.opt_state})
            state.params = tree["params"]
            state.opt_state = tree["opt"]
            state.step = manifest["step"]
            return None, state.step
