"""Rehearse chip_smoke.py's phase 21 (examples/cluster_schedule.py's
path: the dry run, calibrate → plan → simulate, one real reallocation) on
the CPU at toy sizes.

    PYTHONPATH=src python tools/phase21_rehearse.py

First it counts what the phase moves at its real shapes where that is
arithmetic: the parameters of (c)'s model (llama3.2-1b at full width cut
to ``SUBSTRATE_LAYERS`` layers) and the disk a checkpoint takes (the
phase holds one at a time).
Then it runs ``chip_smoke.train_phase`` (for 18(b)'s figures and 18(d)'s
uninterrupted losses, which phase 21 reads) and
``chip_smoke.schedule_phase`` on the CPU with phase 18's stand-ins
(``tools/phase18_rehearse.py``: K5's plain versions counted as the
kernels are, fake CUDA events and memory statistics, the smoke configs
in bf16 for the full ones, sequences of 64 tokens; meta tensors take
K5's meta stand-ins, as the device rule sends them on the card); the
host mesh and ``mesh_for_chips`` draw from the CPU, and the card line
is a stand-in.  The dry run's cells are the smoke configs at
train_4k's batch on meta (the first on the (16, 16) meta mesh), so
every check of the phase runs on that path but the peak's (the CPU
measures none): the cells' keys, flops and collectives, 18(b)'s step
counted and its meta bytes against its real ones,
the plan and the simulation against their CPU runs, the reallocation's
bits, devices, mesh, event and manifest, the resumed loss and the
planted fault.  Its numbers are no measurement of anything.  About 30 s
on an 8-core CPU.
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fo  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402
from repro_torch.sched import elastic  # noqa: E402

CPU = torch.device("cpu")


def counts():
    """(c)'s model and checkpoints at the real shape."""
    cfg = get_config(cs.TRAIN_ARCH).replace(n_layers=cs.SUBSTRATE_LAYERS)
    n = sum(p.numel() for p in Transformer(cfg, device="meta").parameters())
    return {"realloc_params": n,
            "checkpoint_gb": cs.REALLOC_CKPT_BYTES * n / 1e9}


def install():
    """Phase 18's stand-ins, and the CPU as the one device."""
    p18.install()
    # meta tensors take the plain versions, as on the card
    fo.use_cuda_for = lambda x, impl: impl != "ref" and not x.is_meta
    host = launch_mesh.make_host_mesh
    launch_mesh.make_host_mesh = lambda device=None: host(CPU)
    elastic._cards = lambda: [CPU]
    cs.card_line = lambda: "CPU rehearsal, no card"
    # the CPU measures no peak for 18(b)'s counted temp + args
    cs.SCHED_PEAK_RTOL = float("inf")


def main():
    print(json.dumps({"at_the_real_shapes": counts()}))
    install()
    _, _, k5_train, substrate = cs.train_phase(torch, np, CPU)
    launches = cs.schedule_phase(torch, np, CPU, k5_train, substrate)
    print({"launches": launches})


if __name__ == "__main__":
    main()
