"""Rehearse chip_smoke.py's phase 18 (training) on the CPU at toy sizes.

    PYTHONPATH=src python tools/phase18_rehearse.py

Runs ``chip_smoke.train_phase`` on the CPU with stand-ins: K5's forward
and backward wrappers become their plain versions (autograd through
``attention_ref``, the log-sum-exp from the masked scores), counted in
``LAUNCHES`` as the kernels are, and the ops dispatch to them as on the
card; CUDA events, synchronisation, memory statistics and the profiler
are faked; ``get_config`` gives the smoke config in bf16 for the full
one, and the sequence lengths are cut to 64 (32 for the substrate; the
hd-128 timing shape's too).  The faked profiler shows the backward
kernels of the geometry ``bwd_geometry`` gave the last backward call,
named as a trace names them (``chip_smoke.bwd_kernels``).  It
runs every check of the phase on that path, so it finds wrong paths,
shapes, launch counts and control flow before a chip call; its numbers
are no measurement of anything.  About 15 s on an 8-core CPU.
"""
import contextlib
import sys
import types
from pathlib import Path

import numpy as np
import torch
from torch import profiler as torch_profiler
from torch.autograd import DeviceType

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import repro_torch.configs as PC  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fo  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    NEG_INF, attention_ref)
from repro_torch.launch import train as launch_train  # noqa: E402


def forward(q, k, v, *, causal=True, window=None, cap=None,
            return_lse=False):
    fk.LAUNCHES["flash_attention"] += 1
    q, k, v = q.detach(), k.detach(), v.detach()
    out = attention_ref(q, k, v, causal=causal, window=window, cap=cap)
    if not return_lse:
        return out
    B, S, H, hd = q.shape
    T, K = k.shape[1], k.shape[2]
    s = torch.einsum("bskgd,btkd->bkgst",
                     q.reshape(B, S, K, H // K, hd).float(), k.float())
    if cap:
        s = cap * torch.tanh(s / cap)
    qp, kp = torch.arange(S)[:, None], torch.arange(T)[None]
    mask = torch.ones(S, T, dtype=torch.bool)
    if causal:
        mask &= qp >= kp
    if window:
        mask &= (qp - kp) < window
    lse = torch.logsumexp(torch.where(mask, s, NEG_INF), -1)
    return out, lse.reshape(B, H, S)


_LAST_GEOMETRY = [None]   # the geometry of the last backward call


def backward(q, k, v, dout, lse, *, causal=True, window=None, cap=None):
    fk.LAUNCHES["flash_attention_bwd"] += 1
    B, S, H, hd = q.shape
    _LAST_GEOMETRY[0] = fk.bwd_geometry(
        B, S, k.shape[1], H, k.shape[2], hd, q.dtype,
        fk.copies_16_bytes(hd, q.element_size(), q, k, v, dout))
    with torch.enable_grad():
        leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
        attention_ref(*leaves, causal=causal, window=window,
                      cap=cap).backward(dout)
    return tuple(x.grad for x in leaves)


class _Event:
    def __init__(self, **kw):
        pass

    def record(self):
        pass

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return 1.0


class _DeviceRecord:
    def __init__(self, name):
        self._name = name

    def device_type(self):
        return DeviceType.CUDA

    def name(self):
        return self._name

    def duration_ns(self):
        return 1000


def _traced(name):
    """A kernel of ``chip_smoke.bwd_kernels`` as a trace names it:
    demangled, the FMA pair with its element type."""
    base, width = name[:-1].split("<")
    args = width if "_wgmma" in base else f"__nv_bfloat16, {width}"
    return f"void (anonymous namespace)::{base}<{args}>(float const*)"


@contextlib.contextmanager
def _profile(**kw):
    """K5's backward's two kernels of the geometry of its last call,
    demangled as a trace shows them, and K4's backward kernel."""
    def events():
        geo = _LAST_GEOMETRY[0]
        k5 = [] if geo is None else map(_traced, cs.bwd_kernels(geo))
        return [_DeviceRecord(name) for name in
                [*k5, "linear_scan_bwd_kernel"]]
    yield types.SimpleNamespace(profiler=types.SimpleNamespace(
        kineto_results=types.SimpleNamespace(events=events)))


def install():
    """The stand-ins and the smoke config in bf16 (see the docstring)."""
    for mod in (fk, fo):
        mod.flash_attention, mod.flash_attention_bwd = forward, backward
    fo.use_cuda_for = lambda x, impl: impl != "ref"
    torch.cuda.Event = _Event
    torch.cuda.synchronize = lambda *a: None
    torch.cuda.reset_peak_memory_stats = lambda *a: None
    torch.cuda.max_memory_allocated = lambda *a: 0
    torch.cuda.empty_cache = lambda: None
    torch.cuda._sleep = lambda n: None
    torch_profiler.profile = _profile
    configs = PC.get_config

    def get_config(arch, smoke=False):
        cfg = configs(arch, smoke=True)
        return cfg if smoke else cfg.replace(dtype="bfloat16")
    PC.get_config = get_config
    launch_train.resolve_device = lambda device=None: torch.device("cpu")
    cs.TRAIN_SEQ, cs.TRAIN_E2E_SEQ, cs.SUBSTRATE_SEQ = 64, 64, 32
    cs.BWD_HD128_SHAPE = (2, 64, 16, 16, 128)


def main():
    install()
    launches, rec, k5, substrate = cs.train_phase(torch, np,
                                                  torch.device("cpu"))
    print({"launches": launches, "bwd_record": rec, "k5": k5,
           "substrate": substrate})


if __name__ == "__main__":
    main()
