"""Port vs JAX: roofline-calibrated speedups (``sched/speedup_models.py``).

With the same peak and link figures passed to both packages, the leaves
of ``job_speedup`` agree to 1e-15, and ``calibrate_from_dryrun`` reads
a dry-run JSON into the same cells.  The port's defaults are one H100
SXM's (989 TFLOP/s, 450 GB/s), those of ``from_roofline``.
"""
import json

import numpy as np
import pytest
import torch

import repro.sched.speedup_models as JS
import repro_torch.core as P
import repro_torch.sched.speedup_models as PS
from torch_port_util import np_

# the reference's defaults (a TPU chip), passed explicitly to both
TPU = dict(peak_flops=197e12, link_bw=50e9)
JOBS = [
    # (step_flops, grad_bytes, tokens_per_step, overlap)
    (6.0 * 2.0e9 * 256 * 4096, 2.0 * 2.6e9, 256 * 4096, 0.0),
    (6.0 * 7.0e9 * 256 * 4096, 2.0 * 7.0e9, 256 * 4096, 0.3),
    (1.0e12, 2.0e12, 4096, 0.0),        # comm-bound from θ = 1: D ≤ 0
]


def _leaves_close(out, ref):
    assert type(out).__name__ == type(ref).__name__
    for name in ("A", "w", "gamma"):
        np.testing.assert_allclose(np_(getattr(out, name)),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-15, atol=0)
    assert out.sigma == ref.sigma and out.B == ref.B


@pytest.mark.parametrize("job", range(len(JOBS)))
def test_job_speedup_matches_jax(job):
    flops, grad, tokens, overlap = JOBS[job]
    kw = dict(step_flops=flops, grad_bytes=grad, tokens_per_step=tokens,
              B=256.0, overlap=overlap)
    ref = JS.job_speedup(**kw, **TPU)
    out = PS.job_speedup(**kw, **TPU, device="cpu")
    _leaves_close(out, ref)
    h100 = PS.job_speedup(**kw, device="cpu")
    assert torch.equal(h100.A, P.from_roofline(**kw, device="cpu").A)


def test_calibrate_from_dryrun(tmp_path):
    cells = [
        {"ok": True, "arch": "llama3.2-1b", "shape": "train_4k",
         "flops_per_dev": 3.1e15, "n_devices": 8, "active_params": 1.2e9},
        {"ok": True, "arch": "qwen1.5-4b", "shape": "prefill_32k",
         "flops_per_dev": 9.0e15, "n_devices": 16, "active_params": 3.9e9},
        {"ok": True, "arch": "gemma2-27b", "shape": "decode",
         "flops_per_dev": 4.0e13, "n_devices": 4, "active_params": 2.7e10,
         "global_batch": 64},
        {"ok": False, "arch": "dbrx-132b", "shape": "train_4k"},
    ]
    path = tmp_path / "dryrun.json"
    path.write_text(json.dumps(cells))
    ref = JS.calibrate_from_dryrun(str(path), B=128.0, overlap=0.2)
    out = PS.calibrate_from_dryrun(str(path), B=128.0, overlap=0.2,
                                   device="cpu")
    assert sorted(out) == sorted(ref) and len(out) == 3
    h100 = PS.calibrate_from_dryrun(str(path), B=128.0, device="cpu")
    for key in ref:
        assert out[key].B == 128.0
        # the defaults differ (H100 in the port, a TPU chip in the
        # reference): hold the cells at the reference's own figures
        cell = next(c for c in cells if (c["arch"], c["shape"]) == key)
        tokens = {"train_4k": 256 * 4096, "prefill_32k": 32 * 32768}.get(
            key[1], cell.get("global_batch", 128))
        kw = dict(step_flops=cell["flops_per_dev"] * cell["n_devices"],
                  grad_bytes=2.0 * cell["active_params"],
                  tokens_per_step=tokens, B=128.0, overlap=0.2)
        _leaves_close(PS.job_speedup(**kw, **TPU, device="cpu"),
                      JS.job_speedup(**kw, **TPU))
        _leaves_close(out[key], JS.job_speedup(
            **kw, peak_flops=989e12, link_bw=450e9))
        assert h100[key].A.device.type == "cpu"
