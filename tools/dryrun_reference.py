"""The JAX package's dry-run record of the smoke llama3.2-1b × train_4k
on a (2, 4) mesh, under both sharding policies, for the port's tests.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/dryrun_reference.py

Imports ``repro.launch.dryrun``, which asks XLA for 512 host devices
before JAX starts, builds a ("data", "model") mesh of the first 8 and
runs the reference's ``run_cell`` there under ``zero3`` and ``dp_tp``
(one micro-batch each).  Besides each record it writes the compiled
per-device HLO's dot flops (``top_contributors(..., "flops")``), split
into the attention's (the batched dots, whose results have three axes
or more: in llama every other dot is a 2-D matmul) and the rest, and
the product count ``flash_attention_xla``'s blocks give per device: 11
products of 2·hd flops a (query, key) pair of every (q block, kv block)
of the padded square (the forward's QKᵀ and PV, their recompute under
the layer's remat, the q step's checkpointed recompute of both, the kv
step's recompute of QKᵀ and the four products of its backward: 22·hd a
pair); with one q block and one kv block XLA drops one of them (20·hd,
as ``tests/test_torch_dryrun.py`` reads at 64 tokens), over the
device's batch rows and heads.  The record goes to
``tests/torch_records/dryrun_reference_2x4.json`` with the jax version
and this command; ``tests/test_torch_dryrun.py`` reads it, since a JAX
compile over a multi-device host mesh cannot run in the test process.
A run takes about 15 s on a CPU.
"""
import dataclasses
import json
import math
import os
import sys
import tempfile
from pathlib import Path

import repro.launch.dryrun as JD  # noqa: I001  (sets XLA_FLAGS first)

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from repro.configs import SHAPES, get_config  # noqa: E402
from repro.launch.hlo_analysis import top_contributors  # noqa: E402

ARCH, SHAPE, MESH = "llama3.2-1b", "train_4k", (2, 4)
OUT = (Path(__file__).resolve().parents[1] / "tests" / "torch_records"
       / "dryrun_reference_2x4.json")
COMMAND = ("PYTHONPATH=src JAX_PLATFORMS=cpu python "
           "tools/dryrun_reference.py")


def attention_block_flops(cfg, shape, batch_shards, head_shards):
    """``flash_attention_xla``'s product flops per device: 22·hd a pair
    of every (q block, kv block) of the padded square, a layer (20·hd
    with a single block each way)."""
    S = shape.seq_len
    qb, tb = min(512, S), min(1024, S)
    nq, nt = -(-S // qb), -(-S // tb)
    B = shape.global_batch // batch_shards
    H = cfg.n_heads // head_shards
    per_pair = 20.0 if nq * nt == 1 else 22.0
    return per_pair * cfg.head_dim * nq * qb * nt * tb * B * H * cfg.n_layers


def main():
    cfg = get_config(ARCH, smoke=True)
    shape = SHAPES[SHAPE]
    devs = np.array(jax.devices()[:math.prod(MESH)]).reshape(MESH)
    mesh = Mesh(devs, ("data", "model"))
    cells = {}
    for policy in ("zero3", "dp_tp"):
        with tempfile.TemporaryDirectory() as tmp:
            hlo = os.path.join(tmp, "step.hlo")
            rec = JD.run_cell(ARCH, SHAPE, mesh, verbose=False, hlo_out=hlo,
                              cfg=cfg, policy=policy, microbatches=1)
            txt = Path(hlo).read_text()
        rows = top_contributors(txt, "flops", k=10 ** 9)
        attn = sum(r[0] for r in rows if r[3].split("{")[0].count(",") >= 2)
        rec["dot_flops_per_dev"] = float(sum(r[0] for r in rows))
        rec["attention_dot_flops_per_dev"] = float(attn)
        heads = MESH[1] if (policy == "dp_tp"
                            and cfg.n_heads % MESH[1] == 0) else 1
        batch = MESH[0] * (MESH[1] if policy == "zero3" else 1)
        rec["attention_block_flops_per_dev"] = attention_block_flops(
            cfg, shape, batch, heads)
        cells[policy] = rec
        print(policy, json.dumps({k: rec[k] for k in (
            "flops_per_dev", "dot_flops_per_dev",
            "attention_dot_flops_per_dev", "attention_block_flops_per_dev",
            "collective_bytes_per_dev", "collective_bytes_by_op",
            "arg_bytes_per_dev", "temp_bytes_per_dev")}))
    OUT.parent.mkdir(parents=True, exist_ok=True)
    OUT.write_text(json.dumps({
        "jax_version": jax.__version__, "command": COMMAND,
        "arch": ARCH, "smoke": True, "shape": SHAPE,
        "mesh": list(MESH), "axes": ["data", "model"],
        "config": {k: v for k, v in dataclasses.asdict(cfg).items()
                   if isinstance(v, (int, float, str, bool, type(None)))},
        "cells": cells}, indent=1) + "\n")
    print(f"wrote {OUT}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
