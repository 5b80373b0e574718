"""What one class plan costs the card, and how many solves it makes.

    python3 tools/class_solve_time.py              # on the card
    PYTHONPATH=src python tools/class_solve_time.py --count   # on the CPU

On the card: one per-job SmartFill solve (``_solve``, the class knobs)
of ``examples/million_jobs.py``'s instance, one million jobs as 32
classes of 31,250, at N = 1 (the search's start and end) and N = 31
(one step of its exchange search: every adjacent swap), each timed
with the host's clock around a synchronised call, with the card's name
and power limit.  With ``--count``: ``plan_classes`` on the CPU at C =
32 and at C = 8 (125,000 a class), counting its ``_solve`` calls and
their batch sizes.  No JAX.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import repro_torch.core as P  # noqa: E402

PS = sys.modules["repro_torch.core.smartfill"]
B = 10.0
KNOBS = dict(coarse=64, descent_iters=96, cap_iters=64, stol_rel=1e-10)


def instance(C, per, device):
    wl = P.sample_class_workloads(1, K=1, C=C, B=B, count_range=(per, per),
                                  device=device)
    return wl.state(0)


def card():
    if not torch.cuda.is_available():
        sys.exit("class_solve_time: no CUDA device")
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    st = instance(32, 31_250, dev)
    sp, X, W = P.aggregate_classes(st)
    M = X.shape[0]
    gen = torch.Generator().manual_seed(0)
    for N in (1, 31):
        perm = torch.stack([torch.randperm(M, generator=gen)
                            for _ in range(N)]).to(dev)
        args = (PS._permute_speedup(sp, perm), X[perm], W[perm],
                torch.full((N,), B, dtype=X.dtype, device=dev),
                torch.full((N,), M, device=dev))
        t0 = time.perf_counter()
        out = PS._solve(*args, KNOBS["coarse"], KNOBS["descent_iters"],
                        KNOBS["cap_iters"], False, stol_rel=KNOBS["stol_rel"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not bool(torch.isfinite(out[5]).all()):
            sys.exit("class_solve_time: a solve gave a non-finite J")
        print(json.dumps({"C": 32, "N": N, "solve_s": wall,
                          "device": torch.cuda.get_device_name(0)}),
              flush=True)


def count():
    calls = []
    solve = PS._solve

    def counted(sp, x, *args, **kwargs):
        calls.append(int(x.shape[0]))
        return solve(sp, x, *args, **kwargs)

    PS._solve = counted
    for C, per in ((32, 31_250), (8, 125_000)):
        calls.clear()
        t0 = time.perf_counter()
        plan = P.plan_classes(instance(C, per, "cpu"))
        print(json.dumps({"C": C, "per_class": per, "solves": len(calls),
                          "batch_sizes": sorted(set(calls)),
                          "J": plan.J, "cpu_s": time.perf_counter() - t0}),
              flush=True)


if __name__ == "__main__":
    count() if "--count" in sys.argv[1:] else card()
