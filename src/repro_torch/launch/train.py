"""Train launcher: mesh, policy, data, model, the train step and loop,
checkpoints.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --steps 200 [--no-smoke] [--policy zero3] [--resume] [--device cpu]

Trains the architecture's smoke config by default, as the JAX launcher
does (its ``--smoke`` is ``store_true`` with ``default=True``, so it can
never be turned off; here ``--no-smoke`` asks for the full config), with
random weights from seed 0, f32 masters and the config's compute dtype,
on CUDA unless ``--device`` says otherwise.  As the JAX launcher, it
installs the 1×1 host mesh (``launch/mesh.py``) with ``set_mesh`` and
runs under the sharding policy ``--policy`` (``POLICIES``: ``dp_tp``,
``zero3``); the mesh is cleared again when it returns.  One process
drives one device, so a policy changes where specs place the
parameters, never a number.  ``chip_smoke.py`` drives full-width
models through the train step on the card, and this launcher under
each policy.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

from .._device import resolve_device
from ..configs import get_config
from ..data import SyntheticTokens, host_batch_iterator
from ..distributed.sharding import POLICIES, set_mesh, with_logical_rules
from ..models import init_params
from ..train import (AdamWConfig, CheckpointHook, HeartbeatMonitor,
                     TrainState, checkpoint as ckpt, make_train_step,
                     train_loop)
from .mesh import make_host_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--policy", default="dp_tp", choices=sorted(POLICIES))
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=args.smoke)
    dev = resolve_device(args.device)
    set_mesh(make_host_mesh(dev))
    try:
        with with_logical_rules(POLICIES[args.policy]):
            hist = _train(args, cfg, dev)
    finally:
        set_mesh(None)
    l0 = np.mean([h["loss"] for h in hist[:10]])
    l1 = np.mean([h["loss"] for h in hist[-10:]])
    print(f"done: loss {l0:.3f} → {l1:.3f} over {len(hist)} steps on "
          f"{dev}")
    return hist


def _train(args, cfg, dev):
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev, dtype=torch.float32, trainable=True)
    state = TrainState.create(model)
    start = 0
    if args.resume and ckpt.latest(args.ckpt_dir):
        tree, manifest = ckpt.restore(
            ckpt.latest(args.ckpt_dir),
            {"params": state.params, "opt": state.opt_state})
        state.params, state.opt_state = tree["params"], tree["opt"]
        state.step = start = manifest["step"]
        print(f"resumed from step {start}")

    opt = AdamWConfig(lr=3e-3, warmup_steps=20, total_steps=args.steps)
    step_fn = make_train_step(cfg, opt, microbatches=args.microbatches)
    src = SyntheticTokens(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.global_batch)
    it = host_batch_iterator(src, cfg, start_step=start)
    hooks = [CheckpointHook(args.ckpt_dir, every=args.ckpt_every),
             HeartbeatMonitor(n_hosts=1)]
    hist = train_loop(cfg, opt, state, it, args.steps - start,
                      train_step=step_fn, hooks=hooks, log_every=25)
    ckpt.wait_pending()
    return hist


if __name__ == "__main__":
    main()
