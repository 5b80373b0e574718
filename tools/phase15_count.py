"""How many device operations each step of chip_smoke.py's phase 15 issues.

    PYTHONPATH=src python tools/phase15_count.py

Runs ``chip_smoke.stream_phase`` on the CPU with the card's loop
behaviour (a loop that could stop once its rows froze runs out its
count unless it syncs anyway, as ``_device.stops_early`` does on CUDA)
and counts the aten operations dispatched inside the phase's timed
device calls (``chip_smoke.timed_call``; the CPU comparisons are not
counted).  Each of the phase's lines is printed with the operations of
its device calls and their time at 12 µs an operation, the launch cost
of the planner on the H100 (PERF.md §5, PR 17).  No JAX; no timing of
the card.  About four minutes on an 8-core CPU.
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


def main():
    import repro_torch.distributed.fleet  # noqa: F401  (load the loops)
    import repro_torch.serve.stream  # noqa: F401
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
            keep = {k: obj[k] for k in ("events", "replans",
                                        "host_reads_per_event")
                    if k in obj}
            obj = {"phase": obj["phase"], "device_ops": n,
                   "card_s_at_12us": n * US_PER_OP, **keep}
        print(json.dumps(obj), flush=True)

    cs.timed_call = counted
    cs.emit = emit
    cs.stream_phase(torch, np, torch.device("cpu"))


if __name__ == "__main__":
    main()
