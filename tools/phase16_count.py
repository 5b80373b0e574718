"""How many device operations chip_smoke.py's phase 16 issues.

    PYTHONPATH=src python tools/phase16_count.py

(a) Runs ``chip_smoke.cluster_phase`` on the CPU with the card's loop
behaviour (a loop that could stop once its rows froze runs out its count
unless it syncs anyway, as ``_device.stops_early`` does on CUDA) and
counts the aten operations dispatched inside the phase's timed device
calls (``chip_smoke.timed_call``; the CPU references are not counted).
Each line is printed with those operations and their time at 12 µs an
operation, the launch cost of the planner on the H100 (PERF.md §5).

(b) Counts the operations of one falcon-mamba-7b prefill of 2 × 4096
tokens and of one decode step at the full config's depth (64 layers,
``scan_chunk`` 256) but the smoke config's widths: the count of a
layer does not depend on its widths.  The linear scan op is replaced by
a stand-in that issues what its wrapper issues on the card (the output,
the zeroed flags and the carry scratch, then one kernel), so its calls
are counted as well.  No JAX; no timing of the card.  About three
minutes on an 8-core CPU.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
import repro_torch._device as dv  # noqa: E402

US_PER_OP = 12e-6


class OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def card_stops_early(frozen, sync=False):
    return bool(frozen.all()) if sync else False


def cluster_counts():
    import repro_torch.distributed.fleet  # noqa: F401  (load the loops)
    import repro_torch.sched.cluster  # noqa: F401
    for mod in list(sys.modules.values()):
        if getattr(mod, "stops_early", None) is dv.stops_early:
            mod.stops_early = card_stops_early
    pending = [0]
    timed = cs.timed_call

    def counted(sync, run):
        with OpCounter() as c:
            out = timed(sync, run)
        pending[0] += c.n
        return out

    def emit(obj):
        n, pending[0] = pending[0], 0
        if isinstance(obj, dict) and "phase" in obj:
            keep = {k: obj[k] for k in ("events",) if k in obj}
            obj = {"phase": obj["phase"], "device_ops": n,
                   "card_s_at_12us": n * US_PER_OP, **keep}
        print(json.dumps(obj), flush=True)

    cs.timed_call = counted
    cs.emit = emit
    try:
        cs.cluster_phase(torch, np, torch.device("cpu"))
    finally:
        cs.timed_call = timed


def mamba_counts():
    from repro_torch.configs import get_config
    from repro_torch.kernels.linear_scan.kernel import scan_geometry
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.models import scan_ops

    full = get_config(cs.MAMBA_ARCH)
    cfg = get_config(cs.MAMBA_ARCH, smoke=True).replace(
        n_layers=full.n_layers, scan_chunk=full.scan_chunk)
    calls = [0]

    def stand_in(a, b, impl="auto"):
        calls[0] += 1
        geo = scan_geometry(*a.shape)
        y = torch.empty_like(a)
        torch.zeros(geo.flag_ints, dtype=torch.int32)
        torch.empty(geo.carry_floats, dtype=torch.float32)
        return y.copy_(b)           # the kernel: one launch

    scan_ops.linear_scan_op = stand_in
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    toks = np.random.default_rng(0).integers(
        2, cfg.vocab, (cs.BATCH, cs.PROMPT))
    with torch.inference_mode():
        with OpCounter() as c:
            logits, state = prefill(model, {"tokens": toks},
                                    max_len=cs.PROMPT + cs.GEN)
        n_prefill, scans = c.n, calls[0]
        tok = logits.argmax(-1)[:, None]
        with OpCounter() as c:
            decode_step(model, tok, state)
    print(json.dumps({
        "phase": "mamba_prefill", "layers": cfg.n_layers,
        "tokens": [cs.BATCH, cs.PROMPT], "scan_chunk": cfg.scan_chunk,
        "device_ops": n_prefill, "linear_scan_calls": scans,
        "ops_per_layer": n_prefill / cfg.n_layers,
        "host_s_at_12us": n_prefill * US_PER_OP}), flush=True)
    print(json.dumps({
        "phase": "mamba_decode_step", "device_ops": c.n,
        "ops_per_layer": c.n / cfg.n_layers,
        "host_ms_at_12us": c.n * US_PER_OP * 1e3}), flush=True)


def main():
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    if which in ("all", "cluster"):
        cluster_counts()
    if which in ("all", "mamba"):
        mamba_counts()


if __name__ == "__main__":
    main()
