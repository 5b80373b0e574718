"""Wrappers of the CUDA water-filling kernels (``csrc/gwf_waterfill.cu``).

``generic_waterfill``  K1 — batched CAP, one shared regular family.
``hetero_waterfill``   K2 — batched CAP, per-job regular families (§7).
``gwf_waterfill``      K3 — single-instance rectangle-bottle WFP.

Each wrapper takes CUDA tensors only: it checks device, dtype and shape,
casts to contiguous float32 (the kernels compute in float32, as the TPU
kernels did), allocates the output with ``torch.empty``, launches on the
current stream, raises if the launch is refused, and adds one to
``LAUNCHES[name]``.  The library is built from the repo's sources on
first use (``kernels/_build.py``).  The plain versions live in
``ref.py``; ``ops.py`` chooses between the two.
"""
from __future__ import annotations

import ctypes

import torch

from .._build import launch
from .ref import lam_bracket

__all__ = ["LAUNCHES", "generic_waterfill", "hetero_waterfill",
           "gwf_waterfill", "reset_launches"]

# Launches of each kernel since the last reset, counted where the kernel
# is launched and nowhere else.
LAUNCHES = {"generic_waterfill": 0, "hetero_waterfill": 0,
            "gwf_waterfill": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "generic_waterfill_f32": [_P, _P, _P, _I, _I, _I, _I],
    "hetero_waterfill_f32": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I],
    "gwf_waterfill_f32": [_P, _P, ctypes.c_float, _P, _I, _I],
}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _launch(name: str, counter: str, device, *args) -> None:
    launch("gwf_waterfill", name, _SIGNATURES[name], device, *args)
    LAUNCHES[counter] += 1


def _on(x, device, dtype=None):
    """x as a tensor on ``device``: Python numbers are placed there, a
    tensor must already be there (no silent copy across devices)."""
    if isinstance(x, torch.Tensor) and x.device != device:
        raise ValueError(f"expected a tensor on {device}, got one on "
                         f"{x.device}")
    return torch.as_tensor(x, dtype=dtype, device=device)


def _f32(x, device, shape):
    """x as contiguous float32 of ``shape`` on ``device`` (broadcasting)."""
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


def generic_waterfill(c, A, w, gamma, b, *, sigma: int = 1, iters: int = 64):
    """K1: (N, K) c-vectors → (N, K) θ for s'(θ) = A(w + σθ)^γ.

    A, w, gamma, b are (N,) per-instance scalars (or broadcast to it);
    ``sigma`` ∈ {+1, −1} is shared.  Inactive slots are c = 0.  The safe
    λ-bracket is computed on the card in c's dtype (``lam_bracket``).
    """
    _check_cuda(c, 2)
    if sigma not in (1, -1):
        raise ValueError("sigma must be ±1")
    N, K = c.shape
    dev = c.device
    A, w, gamma, b = (torch.broadcast_to(_on(x, dev, c.dtype), (N,))
                      for x in (A, w, gamma, b))
    lam_lo, lam_hi, ds0 = lam_bracket(c, A, w, gamma, b, sigma)
    par = torch.stack([A, w, 1.0 / gamma, b, lam_lo, lam_hi, ds0,
                       torch.zeros_like(A)], dim=1).to(torch.float32)
    par = par.contiguous()
    cf = _f32(c, dev, (N, K))
    theta = torch.empty((N, K), dtype=torch.float32, device=dev)
    _launch("generic_waterfill_f32", "generic_waterfill", dev,
            _ptr(cf), _ptr(par), _ptr(theta), _I(N), _I(K),
            _I(iters), _I(int(sigma)))
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
    theta = torch.empty((N, K), dtype=torch.float32, device=dev)
    _launch("hetero_waterfill_f32", "hetero_waterfill", dev,
            _ptr(cf), _ptr(Af), _ptr(wf), _ptr(gf), _ptr(sf), _ptr(bf),
            _ptr(theta), _I(N), _I(K), _I(iters))
    return theta


def gwf_waterfill(u, h0, b, *, iters: int = 64):
    """K3: rectangle-bottle WFP.  u (M,) widths (0 ⇒ inactive), h0 (M,)
    bottoms, scalar budget b.  Returns θ (M,) with Σθ = b."""
    _check_cuda(u, 1)
    M = u.shape[0]
    dev = u.device
    uf = _f32(u, dev, (M,))
    hf = _f32(h0, dev, (M,))
    theta = torch.empty((M,), dtype=torch.float32, device=dev)
    _launch("gwf_waterfill_f32", "gwf_waterfill", dev,
            _ptr(uf), _ptr(hf), ctypes.c_float(float(b)), _ptr(theta),
            _I(M), _I(iters))
    return theta
