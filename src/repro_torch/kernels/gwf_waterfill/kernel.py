"""Wrappers of the CUDA water-filling kernels (``csrc/gwf_waterfill.cu``).

``generic_waterfill``  K1 — batched CAP, one shared regular family.
``hetero_waterfill``   K2 — batched CAP, per-job regular families (§7).
``gwf_waterfill``      K3 — single-instance rectangle-bottle WFP.

Each wrapper takes CUDA tensors only: it checks device, dtype and shape,
casts to float32 what is not float32 already (the kernels compute in
float32, as the TPU kernels did), allocates the output with
``torch.empty``, launches on the current stream, raises if the launch is
refused, and adds one to ``LAUNCHES[name]``.  K1 and K2 compute their
λ-bracket in the kernel; K1 reads its per-instance A, w, γ and b at an
element stride, 0 for a value every instance shares
(``instance_values``), and all three are launched with the block size in
``THREADS`` and the job tile of ``job_tiles``.  The library is built from
the repo's sources on first use (``kernels/_build.py``).  The plain
versions live in ``ref.py``; ``ops.py`` chooses between the two.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .._build import launch

__all__ = ["LAUNCHES", "generic_waterfill", "hetero_waterfill",
           "gwf_waterfill", "reset_launches", "generic_args",
           "instance_values", "job_tiles", "JobTiles", "THREADS",
           "TILE_JOBS", "SMEM_BYTES", "FIELDS"]

# Launches of each kernel since the last reset, counted where the kernel
# is launched and nowhere else.
LAUNCHES = {"generic_waterfill": 0, "hetero_waterfill": 0,
            "gwf_waterfill": 0}

# Block size of each kernel, the fastest of the 256, 512 and 1024 threads
# each is built for (tools/ablate_kernels.py times the three): for K1 and
# K2 the size at which two instances' job state fits an SM's registers;
# for K3, one instance, the size whose step (pass and barrier) is shortest.
THREADS = {"generic_waterfill": 512, "hetero_waterfill": 256,
           "gwf_waterfill": 512}
# A block's job tile: TILE_JOBS jobs in registers, then up to SMEM_BYTES
# of job state in shared memory, FIELDS floats a job; the rest are
# derived from device memory in every pass.  csrc's kTileJobs and
# kSmemBytes, which the entry points check.
TILE_JOBS = 4096
SMEM_BYTES = 196608
FIELDS = {"generic_waterfill": 3, "hetero_waterfill": 6, "gwf_waterfill": 2}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "generic_waterfill_f32": [_P, _P, _I, _P, _I, _P, _I, _P, _I, _P,
                              _I, _I, _I, _I, _I, _I],
    "hetero_waterfill_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I],
    "gwf_waterfill_f32": [_P, _P, ctypes.c_float, _P, _I, _I, _I, _I],
}


class JobTiles(NamedTuple):
    """Where a block keeps an instance's K jobs: ``reg_jobs`` in
    registers (``jobs_per_thread`` a thread), ``smem_jobs`` in shared
    memory (``smem_bytes``), and ``streamed_jobs`` derived from device
    memory in every pass."""
    jobs_per_thread: int
    reg_jobs: int
    smem_jobs: int
    streamed_jobs: int
    smem_bytes: int


def job_tiles(K: int, threads: int, fields: int) -> JobTiles:
    if threads not in (256, 512, 1024):
        raise ValueError(f"the waterfill kernels are built for 256, 512 or "
                         f"1024 threads, not {threads}")
    reg = min(K, TILE_JOBS)
    smem = min(K - reg, SMEM_BYTES // (4 * fields))
    return JobTiles(TILE_JOBS // threads, reg, smem, K - reg - smem,
                    4 * fields * smem)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launch(name: str, counter: str, device, *args) -> None:
    launch("gwf_waterfill", name, _SIGNATURES[name], device, *args)
    LAUNCHES[counter] += 1


def _on(x, device):
    """x as a tensor on ``device``: Python numbers are placed there, a
    tensor must already be there (no silent copy across devices)."""
    if isinstance(x, torch.Tensor):
        if x.device != device:
            raise ValueError(f"expected a tensor on {device}, got one on "
                             f"{x.device}")
        return x
    return torch.as_tensor(x, device=device)


def _f32(x, device, shape):
    """x as contiguous float32 of ``shape`` on ``device`` (broadcasting);
    a tensor that is that already is passed as it is."""
    if (isinstance(x, torch.Tensor) and x.dtype == torch.float32
            and x.shape == shape and x.device == device
            and x.is_contiguous()):
        return x
    x = _on(x, device)
    if not x.is_floating_point():
        raise TypeError(f"expected a floating tensor, got {x.dtype}")
    return torch.broadcast_to(x.to(torch.float32), shape).contiguous()


def _check_cuda(c, ndim):
    if not isinstance(c, torch.Tensor) or not c.is_cuda:
        raise ValueError("the CUDA waterfill kernels take CUDA tensors; "
                         "use ops.py for CPU tensors")
    if not c.is_floating_point():
        raise TypeError(f"expected a floating tensor, got {c.dtype}")
    if c.ndim != ndim:
        raise ValueError(f"expected a {ndim}-d tensor, got shape "
                         f"{tuple(c.shape)}")


def _ptr(t):
    return _P(t.data_ptr())


def instance_values(x, n: int, device):
    """One of K1's per-instance values as (float32 tensor, element
    stride): stride 0 for a value every instance shares (a number, a
    one-element tensor, or an (n,) tensor expanded from one), else the
    (n,) tensor's own stride.  Casts only what is not float32, so a
    float32 tensor is passed as it lies."""
    if not isinstance(x, torch.Tensor):
        return torch.tensor(float(x), dtype=torch.float32, device=device), 0
    x = _on(x, device)
    if x.ndim > 1 or (x.ndim == 1 and x.shape[0] not in (1, n)):
        raise ValueError(f"expected a per-instance value of shape ({n},), "
                         f"got {tuple(x.shape)}")
    shared = x.ndim == 0 or x.shape[0] == 1 or x.stride(0) == 0
    if x.dtype != torch.float32:
        x = (x.reshape(-1)[:1] if shared else x).to(torch.float32)
    return x, 0 if shared else x.stride(0)


def generic_args(c, A, w, gamma, b):
    """K1's inputs as the kernel reads them: c as contiguous float32
    (N, K), then (tensor, stride) for each of A, w, gamma, b."""
    N, K = c.shape
    return (_f32(c, c.device, (N, K)),
            [instance_values(x, N, c.device) for x in (A, w, gamma, b)])


def generic_waterfill(c, A, w, gamma, b, *, sigma: int = 1, iters: int = 64):
    """K1: (N, K) c-vectors → (N, K) θ for s'(θ) = A(w + σθ)^γ.

    A, w, gamma, b are (N,) per-instance values or one value for all;
    ``sigma`` ∈ {+1, −1} is shared.  Inactive slots are c = 0.  The safe
    λ-bracket is computed in the kernel, as ``ref.lam_bracket`` does.
    """
    _check_cuda(c, 2)
    if sigma not in (1, -1):
        raise ValueError("sigma must be ±1")
    N, K = c.shape
    cf, vals = generic_args(c, A, w, gamma, b)
    threads = THREADS["generic_waterfill"]
    tiles = job_tiles(K, threads, FIELDS["generic_waterfill"])
    theta = torch.empty((N, K), dtype=torch.float32, device=c.device)
    _launch("generic_waterfill_f32", "generic_waterfill", c.device,
            _ptr(cf), *[a for t, st in vals for a in (_ptr(t), _I(st))],
            _ptr(theta), _I(N), _I(K), _I(iters), _I(int(sigma)),
            _I(threads), _I(tiles.smem_jobs))
    return theta


def hetero_waterfill(c, A, w, gamma, sigma, b, *, iters: int = 64):
    """K2: per-job families — c, A, w, gamma, sigma (N, K); b (N,).

    Inactive slots are c = 0 and must carry valid family parameters
    (edge-replicated, never zeroed).
    """
    _check_cuda(c, 2)
    N, K = c.shape
    dev = c.device
    cf, Af, wf, gf, sf = (_f32(x, dev, (N, K)) for x in (c, A, w, gamma,
                                                          sigma))
    bf = _f32(b, dev, (N,))
    threads = THREADS["hetero_waterfill"]
    tiles = job_tiles(K, threads, FIELDS["hetero_waterfill"])
    theta = torch.empty((N, K), dtype=torch.float32, device=dev)
    _launch("hetero_waterfill_f32", "hetero_waterfill", dev,
            _ptr(cf), _ptr(Af), _ptr(wf), _ptr(gf), _ptr(sf), _ptr(bf),
            _ptr(theta), _I(N), _I(K), _I(iters), _I(threads),
            _I(tiles.smem_jobs))
    return theta


def gwf_waterfill(u, h0, b, *, iters: int = 64):
    """K3: rectangle-bottle WFP.  u (M,) widths (u ≤ 0 ⇒ inactive), h0
    (M,) bottoms, scalar budget b.  Returns θ (M,) with Σθ = b, or zeros
    where no bottle is active.  ``iters`` bounds the halvings of the level
    bracket; the kernel stops earlier, with the same bits, at the
    bisection's float32 fixed point."""
    _check_cuda(u, 1)
    M = u.shape[0]
    dev = u.device
    uf = _f32(u, dev, (M,))
    hf = _f32(h0, dev, (M,))
    threads = THREADS["gwf_waterfill"]
    tiles = job_tiles(M, threads, FIELDS["gwf_waterfill"])
    theta = torch.empty((M,), dtype=torch.float32, device=dev)
    _launch("gwf_waterfill_f32", "gwf_waterfill", dev,
            _ptr(uf), _ptr(hf), ctypes.c_float(float(b)), _ptr(theta),
            _I(M), _I(iters), _I(threads), _I(tiles.smem_jobs))
    return theta
