"""Rehearse chip_smoke.py's phase 19 (training through K4's backward) on
the CPU at toy sizes.

    PYTHONPATH=src python tools/phase19_rehearse.py

Runs ``chip_smoke.scan_train_phase`` on the CPU with phase 18's
stand-ins (``tools/phase18_rehearse.py``: K5's plain versions, fake CUDA
events, memory statistics and profiler, the smoke configs in bf16) and
K4's: its forward and backward wrappers become their plain versions
(``linear_scan_ref``, ``linear_scan_bwd_ref``), counted in ``LAUNCHES``
as the kernels are, and the scan op dispatches to them as on the card.
The shapes are cut: K4's path shapes and ``K4_OPTIONS`` to a few
hundred steps (the long chain to 5,000 steps, past a plain-autograd
cut of 1,000), K5's local layer to 64 tokens and a window of 16, the
training sequences to 64 tokens.  It runs every check of the phase on
that path, so it finds wrong paths, shapes, launch counts and control
flow before a chip call; its numbers are no measurement of anything.
It also counts the phase's device work at its real shapes where that is
arithmetic: the bytes each K4 backward call moves and the launches a
training step makes.  About 30 s on an 8-core CPU.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
import phase18_rehearse as p18  # noqa: E402
from repro_torch.kernels.linear_scan import kernel as sk  # noqa: E402
from repro_torch.kernels.linear_scan import ops as so  # noqa: E402
from repro_torch.kernels.linear_scan.ref import (  # noqa: E402
    linear_scan_bwd_ref, linear_scan_ref)


def forward(a, b):
    sk.LAUNCHES["linear_scan"] += 1
    return linear_scan_ref(a, b)


def backward(a, h, dh):
    sk.LAUNCHES["linear_scan_bwd"] += 1
    return linear_scan_bwd_ref(a, h, dh)


def real_counts():
    """What the phase moves and launches at its real shapes."""
    from repro_torch.configs import get_config
    out = {}
    for name, shape in (("rglru", cs.K4_RGLRU_SHAPE),
                        ("mamba", cs.K4_MAMBA_SHAPE)):
        n = int(np.prod(shape))
        out[f"k4_bwd_{name}"] = {
            "shape": shape, "bytes_f32": 20 * n,
            "bound_ms": cs.bound(20 * n, 4 * n)[0],
            "geometry": sk.scan_bwd_geometry(*shape)._asdict()}
    for arch in cs.SCAN_ARCHS:
        cfg = get_config(arch)
        layers = cs.SCAN_TRAIN_LAYERS.get(arch, cfg.n_layers)
        cfg = cfg.replace(n_layers=layers)
        out[f"train_{arch}"] = {
            "layers": layers,
            "per_step": cs.train_launches(cfg, cs.TRAIN_SEQ,
                                          cs.SCAN_TRAIN_MICRO)}
    return out


def main():
    counts = real_counts()
    p18.install()
    for mod in (sk, so):
        mod.linear_scan, mod.linear_scan_bwd = forward, backward
    so.use_cuda_for = lambda x, impl: impl != "ref"
    cs.K4_RGLRU_SHAPE, cs.K4_MAMBA_SHAPE = (2, 100, 40), (2, 64, 48)
    cs.K4_OPTIONS = {"one_step": (2, 1, 40), "under_one_chunk": (2, 20, 40),
                     "ragged_chunks": (3, 100, 40),
                     "ragged_lanes": (1, 77, 9),
                     "long_chain": (1, 5000, 8), "serving": (2, 200, 40)}
    cs.K4_BWD_AUTOGRAD_MAX_S = 1000
    cs.K5_LOCAL_SHAPE, cs.K5_LOCAL_WINDOW = (2, 64, 10, 1, 256), 16
    # at the smoke width the launcher's warm-up moves the loss by ~1e-3,
    # which the first update may not lower: a faster warm-up here
    cs.TRAIN_OPT = {"lr": 3e-2, "warmup_steps": 2}
    launches, k4, k5 = cs.scan_train_phase(torch, np, torch.device("cpu"))
    print(json.dumps({"real_shapes": counts}))
    print({"launches": launches, "k4_bwd_record": k4, "k5_hd256": k5})


if __name__ == "__main__":
    main()
