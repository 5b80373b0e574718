"""Roofline-calibrated speedup functions: from a training job to s(θ).

A data-parallel training job on θ GPUs has step time

    t(θ) = F/(θ·R) + (1 − overlap) · 2·P·(θ−1)/(θ·W)

(F = FLOPs a step, R = one GPU's peak, P = gradient bytes, W = link
bandwidth; (θ−1)/θ is the ring all-reduce).  Its throughput speedup
s(θ) = D/t(θ) is ``a·z^p − a·(θ+z)^p`` with p = −1, row 3 of the
paper's Table 1: a regular speedup function.

``calibrate_from_dryrun`` builds one per (arch, shape) cell of a dry
run's JSON from its measured FLOPs and parameter counts.  The defaults
are one H100 SXM: 989 TFLOP/s dense bf16 and 450 GB/s of NVLink.
"""
from __future__ import annotations

import json

from ..core.speedup import RegularSpeedup, from_roofline

__all__ = ["calibrate_from_dryrun", "job_speedup"]


def job_speedup(step_flops: float, grad_bytes: float, tokens_per_step: float,
                B: float, peak_flops: float = 989e12, link_bw: float = 450e9,
                overlap: float = 0.0, device=None) -> RegularSpeedup:
    """Speedup function of one data-parallel job from its roofline terms;
    its leaves go to ``device`` (default CUDA)."""
    return from_roofline(tokens_per_step=tokens_per_step,
                         step_flops=step_flops, grad_bytes=grad_bytes,
                         B=B, peak_flops=peak_flops, link_bw=link_bw,
                         overlap=overlap, device=device)


def calibrate_from_dryrun(dryrun_json: str, B: float = 256.0,
                          overlap: float = 0.0, device=None) -> dict:
    """One calibrated speedup function per dry-run cell.

    Returns {(arch, shape): RegularSpeedup}.  The FLOPs a step are the
    per-device FLOPs × devices (the whole job's work); the gradient is
    2 bytes per (active) parameter, a bf16 all-reduce.  Cells whose
    ``ok`` is false are skipped.
    """
    with open(dryrun_json) as f:
        cells = json.load(f)
    out = {}
    for cell in cells:
        if not cell.get("ok"):
            continue
        step_flops = cell["flops_per_dev"] * cell["n_devices"]
        grad_bytes = 2.0 * cell["active_params"]
        if cell["shape"] == "train_4k":
            tokens = 256 * 4096
        elif cell["shape"] == "prefill_32k":
            tokens = 32 * 32768
        else:
            tokens = cell.get("global_batch", 128)
        out[(cell["arch"], cell["shape"])] = job_speedup(
            step_flops=step_flops, grad_bytes=grad_bytes,
            tokens_per_step=tokens, B=B, overlap=overlap, device=device)
    return out
