#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check what comes out.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each one is a check; any failure exits non-zero):
  1. the card: CUDA must be available; prints name and power limit;
  2. the build: nvcc builds the kernels from src/repro_torch/**/csrc;
     prints each instantiation's registers and spill bytes from the
     ptxas report, fails if an instantiation of K1, K2, K3 or K5's
     backward spills, and fails unless the SASS of every bf16
     instantiation of K5 holds tensor-core instructions (HMMA or HGMMA)
     and that of each of the backward's four wgmma instantiations HGMMA;
  3. the batched CAP front door at full width (N = 256 tenants ×
     k = 4096 jobs, float32): ``solve_cap_batched(impl="auto")`` with a
     shared shifted power (CUDA kernel generic_waterfill) and a per-job
     power/log/saturating mix (hetero_waterfill); then the same shared
     call in float64, which ``impl="auto"`` must keep off the float32
     kernels: float64 out, no launch, the float64 closed form to 1e-12
     (``cap_dtype_rule``, with both dtypes' times);
  4. the level WFP: ``gwf_waterfill_op`` at k = 4096 with 25% inactive
     bottles (gwf_waterfill).
     Phases 3–4 hold each kernel against its plain version (and K1, K3
     against the float64 closed form) per row in units of the mean
     allocation, check the KKT conditions (K1, K2) or the common level
     and budget (K3), and show that planted faults fail those checks;
     then K1 and K2 the same ways on ``CAP_OPTIONS`` (pure and saturating
     shared families, K = 1, 37, 5000 and 65536, N = 1, a row with no
     active job, b = 1e-3), each with its bisection cut short, and K3 on
     ``K3_OPTIONS`` (M = 1 … 65536, one or no active bottle, b = 1e-3, a
     level at 0); phase 4 also counts the steps K3's bisection takes to
     its float32 fixed point (``k3_fixed_point_steps``), which must
     exceed the cut-short fault's;
  5. planning on the card in float64: the quickstart instance, the
     batched-planning instance, and ``smartfill_batched`` at N = 256,
     M = 32 against the port's own CPU run;
  6. times: each kernel and its plain version (CUDA events, median of
     25 after a warm-up), the wall time of each planning phase, and a
     profile of each op's device kernels (K1's must be at most two a
     call: its bracket is the kernel's);
  7. serving: full-width recurrentgemma-2b in bf16 (random weights from
     a seeded generator on the card), ``ServeEngine.generate`` over two
     waves of B = 2 prompts of 4096 tokens (past the 2048 window), 16
     greedy tokens each; per wave the prefill ms, decode ms per token,
     tokens/s and peak memory.  Every prefill must launch the flash
     attention kernel (K5) once per local layer (8) and the linear scan
     kernel (K4) once per RG-LRU layer (18).  ``serve_phase``,
     ``end_to_end_phase`` and ``kernel_record`` take the arch, so phase
     16(b) and 17 drive other archs through them;
  8. K5 and K4 against their plain versions on the q/k/v of the first
     local layer and the a/b of the first RG-LRU layer of wave 0: in f32
     (the inputs cast up, both run there) to a limit in units of the
     plain output's RMS, in bf16 to a wider relative limit, with planted
     faults that must read over the f32 limits; K5's bf16 (tensor-core)
     output also against the f32 plain output of the same bf16 inputs in
     RMS units, with the planted faults run through the bf16 kernel;
     then K5 the same ways on the option sets of the dense configs and of
     the wrapper's edges (``K5_OPTIONS``: softcap, grouped-query heads at
     hd 64 and 128, global causal, ragged and cross lengths, rows with no
     unmasked key), and K4 on shapes that test its chunks and lanes
     (``K4_OPTIONS``: one step, under one chunk, ragged chunks and lanes,
     a 65536-step look-back chain, the serving shape);
  9. end to end: wave 0's prompt through the model with its two kernel
     call sites patched to the plain versions, teacher-forced on the
     kernel run's tokens; prefill and decode logits in units of the logits' std,
     with planted faults that must read over the limit;
 10. times of K4 and K5 at the path's shapes (kernel, plain version,
     the kernel's device time from the profiler, the bound, for K5 one
     ``scaled_dot_product_attention`` call as a yardstick and the f32
     instantiation's time), and a
     profile of one wave: the device's busy share in prefill and decode;
 11. per-job SmartFill (paper §7) in float64 on the card, counted
     (``hetero_*`` lines): the sampler's five-family per-job fleet (N =
     256, M = 32, 2..32 live jobs) through ``smartfill_hetero_batched``,
     held to the port's CPU run (same orders, J to 1e-9), to J_linear,
     and at its largest instance to ``smartfill_hetero`` (1e-6), with
     its wall time (its profile, a reading of ~90 s, is gone: phase
     13(a)'s one-solve profile reads the same recursion's busy share);
     the exchange search (windows 1 and 2) on eight mixed members, card
     against CPU; ``smartfill_warm`` seeded by its own first run against
     a cold plan; no K1–K5 launch in the phase;
 12. the scenario engine (``engine_*`` lines), float64 unless said,
     each run of ``simulate_ensemble`` held against the port's own CPU
     run of the same call (J and T to 1e-6, the same n_events): (a)
     ``examples/policy_faceoff.py`` at its size (the five-policy zoo, K
     = 128 workloads, M = 8, ln(1+θ)), its table printed, SmartFill's
     mean gap 0 and every baseline's above 0; (b) the zoo at K = 1024 ×
     M = 32 under s = √θ, plain (SmartFill ≤ heSRPT·(1 + 1e-9) on every
     workload), with arrivals and with a fault trace per workload, with
     wall time, events/s, instances/s and, for the plain run, device
     kernels and busy share; (c) the per-job five-family
     fleet (K = 128, M = 16) under the pinned heteroSF with its cached
     plan (simulated J equal to the plan's on realized orders) and WMR,
     then a budget step that must invalidate the cached table (the
     host oracle on the moved workloads, the finished ones bit for
     bit); (d) GWF-static and WMR in float32, whose CAP runs K1 and K2
     at every event, J held to the float64 run within ``F32_LIMIT``,
     which the kernels' bisection cut to ``FAULT_ITERS`` steps must
     exceed.  Rehearse on the CPU with ``engine_phase(torch, np,
     torch.device("cpu"))``;
 13. class-aggregated planning in float64 (``classes_*`` lines): (a)
     one million jobs as 5 classes through ``plan_classes`` (Σθ = B, J
     = J_linear, J against the JAX package's and the port's CPU J, the
     numpy oracle not below it; wall time, jobs/s, one solve's device
     kernels and busy share); (b) ``plan_classes`` against
     ``smartfill_hetero`` at one job per class, bit for bit; (c) (a)'s
     plan drained by the pinned, cached ``ClassSmartFillPolicy``
     through ``simulate_fluid_classes``, card against CPU; (d) 32 class
     instances through ``plan_classes_batched``, card against CPU; (e)
     ``examples/hetero_fleet.py``: six of the ten configs' roofline
     speedups on one 256-GPU pod, card against CPU, WMR not below the
     plan; no
     K1–K5 launch.  Rehearse on the CPU with ``classes_phase(torch, np,
     torch.device("cpu"))``;
 14. the robustness layer, fleet planning at D = 1 and admission
     control in float64 (``robust_*``, ``fleet_*``, ``admission_*``
     lines): (a) the ladder SmartFill → GWF-static → EQUI on 12(b)'s
     plain fleet, J, T and n_events bit for bit equal to SmartFill
     alone, with wall, device kernels, busy share and kernels an event
     of both; ``degradation_report`` on a face-off instance, card
     and CPU, every event on rung 0; (b) the ladder with its primary
     sabotaged (NaN, overspend, negative while more than four jobs are
     active) over the face-off's 128 workloads, card against CPU (J, T
     1e-6, the same n_events), the same rung counts, rung 1 used in
     every mode; (c) ``certify_plan`` on phase 5's quickstart schedule
     and phase 11's largest per-job plan, and two planted faults (a
     column × 1.01 fails on the budget, two jobs swapped on the KKT
     rows); (d) ``examples/fleet_sweep.py`` on a one-card mesh:
     ``plan_sharded`` (K = 1000 in chunks of 192),
     ``simulate_ensemble_sharded`` (K = 256 in chunks of 60, with
     arrivals and with a fault trace per workload, under √θ) and
     ``plan_classes_sharded`` (K = 5, C = 5, chunks of 3), each bit for bit
     equal to its unsharded call on the card and held to the CPU; (e)
     ``examples/batched_planning.py`` §3's admission control, card
     against CPU (ΔJ 1e-9, the same admitted indices), the simulate
     estimator (1e-6, bit for bit with and without a fleet mesh), a
     deep queue (32 running, 255 candidates: 256 instances of 33 jobs),
     mixed-model scoring over the ten configs' speedups, and the
     watchdog in virtual time; no K1–K5 launch.  Rehearse on the CPU
     with ``robust_phase(torch, np, torch.device("cpu"))`` (~160 s);
     ``tools/phase14_count.py`` counts its device operations.
 15. the streaming control plane and the fleet's stream service in
     float64 under s = √θ, B = 10 (``stream_*`` and ``fleet_streams``
     lines): (a) the committed trace
     ``benchmarks/traces/arrivals_sample.csv`` and (b) the quick day
     trace of ``benchmarks/perf_serve.py::bench_stream`` (seed 17, its
     first 45 minutes of 2 h, M = 8), each through
     ``StreamController.run`` with ``StreamCascadePolicy``, through
     ``run_device`` and through
     ``run_device`` in chunks of 17 events, bit for bit among the three
     on the card and held to the CPU's ``run_device`` (the same counters
     and finished set, completions and weighted J to 1e-9; (a) completes
     139 of its 141 arrivals, as the reference does), with wall time,
     events/s and host reads an event, and for (b) the kernels a replan
     and the busy share from a profile of its first 20 events; (c) (b)'s
     trace under the default ``StreamingSmartFillPolicy``, card against
     CPU; (d) a primary planner that raises: every replan on the ladder,
     every admitted job completes, card against CPU; (e)
     ``serve_streams_sharded`` at D = 1 over two of its four tenants
     (seeds 17–18, the first 15 of their 30 min, M = 8), each bit for bit to its solo ``run_device``, the
     admission view equal to the CPU's; no K1–K5 launch (the float64
     CAP takes the closed form).  The CPU references run in spawned
     worker processes beside the card's runs.  Rehearse on the CPU with
     ``stream_phase(torch, np, torch.device("cpu"))`` (~115 s);
     ``tools/phase15_count.py`` counts its device operations.
 16. the cluster scheduler and Mamba serving: (a) ``sched/cluster.py``
     in float64 (``cluster_*`` lines), each call held to the port's CPU
     run of it (run in spawned workers beside the card's runs): the
     eight fleets of ``examples/batched_planning.py`` §2 through
     ``current_allocations_fleets`` (Σθ = B); the 12 jobs on 256 GPUs of
     ``benchmarks/cluster_sim.py::bench_cluster`` through the cost-free
     device path (SmartFill ≤ heSRPT), the host loop with a 30 s
     reallocation cost and 2-chip merging, and integer chips (J to 1e-9,
     the same allocation changes, their times and allocations to 1e-7:
     SmartFill's schedule off the pure-power path; the event counts are
     printed, and may differ by the host loop's ghost events,
     ``schedule_of``); six of the ten configs'
     roofline speedups as one 256-GPU pod (ten until phase 18 needed the
     room; the plan against
     ``smartfill_hetero``, the device path against the host loop to
     1e-5); 256 fleets under a one-card fleet mesh, bit for bit to the
     call without one; no K1–K5 launch.  (b) falcon-mamba-7b at full
     width and 16 of its 64 layers (``mamba_*`` lines) through phase 7's
     and 9's helpers: two waves of B = 2 prompts of 4096 tokens, 16
     greedy tokens each, every prefill launching K4 exactly 16 layers ×
     16 chunks = 256 times and K5 never; K4 against its plain version across the first layer's
     first chunk boundary (the carry folded into the second chunk), with
     the carry dropped as a planted fault; wave 0 end to end through the
     plain scan; K4's times at the chunk shape and the cost of its
     wrapper's scratch.  Rehearse (a) with ``cluster_phase(torch, np,
     torch.device("cpu"))`` (~50 s); ``tools/phase16_count.py`` counts
     both parts' device operations.
 17. the rest of the serving stack through K5, each model at full width
     in bf16 from a seeded generator on the card and freed before the
     next, through ``serve_phase``: (a) qwen2-moe-a2.7b (24 layers, 60
     routed experts top-4 and 4 shared, dispatch at 8 groups of 1024
     with C = 88; ``moe_*`` lines), two waves of 2 × 4096 tokens, 16
     greedy tokens each, K5 exactly 24 times a prefill, wave 0's routes
     (choices dropped by capacity and the largest expert load a layer);
     K5 against its plain version on layer 0's q/k/v (``k5_path_check``:
     f32 and bf16 readings, planted faults); K5's times at that shape
     with SDPA as the yardstick; wave 0 end to end (``end_to_end_phase``
     with ``perturb``: the limits and the route and drop differences
     held to twice a measured floor, the plain run against itself with
     noise of K5's reading's size; the f32 pass at its first 4 layers);
     (b) dbrx-132b at 2 of its 40 layers (no shared experts, E = 16, C =
     320, GQA 48:8), one wave, 2 K5 launches a prefill, K5 against its
     plain version; (c) internvl2-1b, 256 patches and 3840 tokens (St =
     4096), 24 K5 launches a prefill (GQA 7:1, hd 64), K5 against its
     plain version, end to end; (d) seamless-m4t-medium, 4096 frames and
     a 512-token decoder prompt, 36 K5 launches a prefill (12
     non-causal over the frames, 12 causal over 512, 12 cross S 512, T
     4096), K5 against its plain version on the first encoder layer's
     and the first cross-attention's inputs, end to end.
     ``tools/phase17_count.py`` counts its device operations;
 18. training (``train_*`` lines): (a) K5's backward kernel
     (``flash_attention_bwd.cu``) against autograd through its plain
     version on llama's path shape at one layer (4, 4096, 32:8, 64)
     causal and on every ``K5_OPTIONS`` case, in f32 and bf16, with
     planted faults of the backward (dK/dV of one head a GQA group, the
     causal mask flipped, the softcap dropped, the window one wider), and
     the backward kernels each bf16 case ran (the wgmma pair on its
     ``bwd_geometry`` route, at hd 64, 96 and 128; the FMA pair at hd
     33); its op, device (by kernel), plain and SDPA-backward ms and its
     bound there and, but for the plain version, at qwen2-moe's hd-128
     training shape (2, 4096, 16:16, 128); (b)
     llama3.2-1b at full width and depth (1.236 B parameters, f32
     masters, bf16 compute, remat "full") trains 8 steps of 8 × 4096
     tokens in 2 micro-batches through ``make_train_step``/
     ``train_loop``: every loss finite and falling from ≈ ln V, step ms,
     tokens/s, peak memory, and exactly 64 K5 forward and 32 backward
     launches a step; (c) one step at 1 × 4096 through the kernels and
     through the plain versions, loss, gradient norm and the largest
     per-leaf gradient distance within twice a floor (the plain run
     against itself with noise of (a)'s readings, two seeds); (d) on a
     two-layer cut of the full width: the NaN guard (bit for bit),
     save-and-resume and ``RetryableStep`` (the uninterrupted run's
     losses to the spread of two uninterrupted runs), ``adamw_update``
     on the card against its CPU run, and ``python -m
     repro_torch.launch.train`` at the smoke config.
 19. training through K4's backward (``train_scan_*`` / ``train_k4_*``
     lines): (a) K4's backward kernel (``linear_scan_bwd.cu``, behind
     ``ops.LinearScan``) against autograd through its plain version on
     RG-LRU's path shape (2, 4096, 2560), Mamba's chunk (2, 256,
     131072) with a carry folded in, and every ``K4_OPTIONS`` case, in
     f32 and bf16, the same bits twice, with planted faults (the carry
     dropped at every chunk boundary, da reading h_t for h_{t−1}, the
     coefficient a_t for a_{t+1}), and its times at both path shapes;
     (a′) K5 at recurrentgemma's local layer (2, 4096, 10:1, 256),
     window 2048: the forward's log-sum-exp and the backward (the FMA
     pair) at phase 18(a)'s limits and faults, its times beside SDPA's
     backward; (b) recurrentgemma-2b at full width and depth and (c)
     falcon-mamba-7b at 16 of its 64 layers train 4 steps of 4 × 4096
     tokens in 2 micro-batches, every loss finite, the first update
     lowering it, exactly 72 K4 forward, 36 backward, 32 K5 forward and
     16 backward launches a step (recurrentgemma) and 1,024 and 512 K4
     launches (Mamba); (d) one step at 1 × 4096 through the kernels
     against the plain versions at 3 recurrentgemma and 2 Mamba layers,
     within twice a floor.  ``tools/phase19_rehearse.py`` rehearses it
     on the CPU.

Launch counters are reset before phases 3–4 drive the planning path,
before phases 7, 16(b) and each part of 17 drive the serving paths, before phases 11,
13, 14, 15 and 16(a), before each float32 run of phase 12 and before
the training runs of phases 18(b), 19(b) and 19(c), and read right
after each;
the comparisons and timings come later and do not count.  Prints one
JSON line per measurement, the kernel summary line ``{"kernels": [...]}``
(seven kernels, each with its device ms; K1 and K2 also with their
launches inside the engine, ``engine_launches``; K4 also with its Mamba
path's launches and times, ``mamba_path``; K5 also with phase 17's
launches, ``new_paths_launches``, its times at qwen2-moe's shape,
``moe_shape``, and its training figures, ``train``; K5's backward with
its launches in phase 18(b) and its times at the hd-128 shape,
``hd128_shape``, and at recurrentgemma's hd-256 local layer,
``hd256_shape``; K4's backward with its launches in phase 19(b)–(c),
its times at both path shapes and its training figures), the card
line, and last
``{"ok": true, "device": {...}}``.
Imports nothing of JAX.
"""
import contextlib
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
CU = "src/repro_torch/kernels/gwf_waterfill/csrc/gwf_waterfill.cu"
TPU_KERNELS = "src/repro/kernels/gwf_waterfill/kernel.py"
CU_K5 = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
CU_K4 = "src/repro_torch/kernels/linear_scan/csrc/linear_scan.cu"
TPU_K5 = "src/repro/kernels/flash_attention/kernel.py:77"
TPU_K4 = "src/repro/kernels/linear_scan/kernel.py:53"

N, K = 256, 4096          # tenants × jobs of the batched front door
B = 10.0
ITERS = 64
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and FP32 (non-tensor)
# operations/s.  Each transcendental counts as one FP32 operation, so the
# operation bound is a floor.
HBM_BPS = 3.35e12
FP32_OPS = 67e12
BF16_TC_OPS = 989e12      # dense bf16 tensor-core peak

# the serving phases: one full-width model, two waves of requests (three
# until phase 17 needed the room)
ARCH = "recurrentgemma-2b"
WAVES, BATCH, PROMPT, GEN = 2, 2, 4096, 16
# phase 16(b): full-width Mamba at MAMBA_LAYERS of its 64 layers (all 64
# until phase 17 needed the room), two waves of the same requests
MAMBA_ARCH, MAMBA_WAVES, MAMBA_LAYERS = "falcon-mamba-7b", 2, 16
# phase 17: the MoE (two waves), dbrx at two of its 40 layers (132 B
# parameters do not fit one card), the VLM (its 256 patches and 3840
# tokens fill PROMPT positions) and the encoder–decoder (ENCDEC_FRAMES
# frames, an ENCDEC_PROMPT-token decoder prompt), one wave each.  The
# MoE's f32 end-to-end pass runs its first MOE_F32_LAYERS layers: an f32
# copy at its 24 would be 57 GB beside the 28.6 GB bf16 model.
MOE_ARCH, MOE_WAVES, MOE_F32_LAYERS = "qwen2-moe-a2.7b", 2, 4
DBRX_ARCH, DBRX_LAYERS = "dbrx-132b", 2
VLM_ARCH = "internvl2-1b"
ENCDEC_ARCH, ENCDEC_FRAMES, ENCDEC_PROMPT = "seamless-m4t-medium", 4096, 512


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok, msg):
    if not ok:
        fail(msg)


def emit(obj):
    print(json.dumps(obj), flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def build_report(_build):
    """Phase 2: registers and spill bytes of every kernel instantiation
    from the ptxas reports, and the tensor-core instructions (HMMA,
    HGMMA) in the SASS of each K5 instantiation and of each of K5's
    backward; fails if K1, K2, K3 or any backward kernel (K5's, K4's)
    spills (K4's forward spills 44 bytes: reported, not held), unless
    every bf16 instantiation of K5 holds some, or unless each of the
    backward's four wgmma instantiations (dQ and dK/dV at widths 64 and
    128) holds HGMMA."""
    usage = {}
    for name in _build.SOURCES:
        report = _build.ptxas_report(name)
        check(report, f"no ptxas report for {name}")
        for fn, u in _build.ptxas_usage(report).items():
            usage[_build.kernel_label(fn)] = u
    for label, u in usage.items():
        if label.split("<")[0] in ("generic_waterfill_kernel",
                                   "hetero_waterfill_kernel",
                                   "gwf_waterfill_kernel") or \
                label.startswith(("flash_attention_bwd_",
                                  "linear_scan_bwd_")):
            check(u.get("spill_store_bytes", 0) == 0
                  and u.get("spill_load_bytes", 0) == 0,
                  f"{label} spills: {u}")
    cuobjdump = Path(_build.find_nvcc()).parent / "cuobjdump"
    counts = {}
    for name, kernel in (("flash_attention", "flash_attention_kernel"),
                         ("flash_attention_bwd", "flash_attention_bwd_")):
        lib = _build.library_path(name)
        out = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                             capture_output=True, text=True, timeout=300)
        check(out.returncode == 0, f"cuobjdump -sass {lib.name} failed: "
                                   f"{out.stderr.strip()[-500:]}")
        counts.update({_build.kernel_label(fn): c for fn, c in
                       _build.sass_counts(out.stdout,
                                          ("HMMA", "HGMMA")).items()
                       if kernel in fn})
    bf16 = {k: c for k, c in counts.items()
            if k.startswith("flash_attention_kernel<bf16,")}
    check(len(bf16) == 3, f"K5's SASS lacks bf16 instantiations: {counts}")
    for k, c in bf16.items():
        check(c["HMMA"] + c["HGMMA"] > 0,
              f"{k} holds no tensor-core instruction: {c}")
    wg = {k: c for k, c in counts.items() if "_wgmma_kernel<" in k}
    check(sorted(wg) == [f"flash_attention_bwd_{k}_wgmma_kernel<{w}>"
                         for k in ("dkdv", "dq") for w in (128, 64)],
          f"K5 bwd's SASS lacks wgmma instantiations: {sorted(counts)}")
    for k, c in wg.items():
        check(c["HGMMA"] > 0, f"{k} holds no HGMMA: {c}")
    return usage, counts


def timed(torch, fn, runs=25):
    """Median milliseconds of ``fn`` over ``runs`` CUDA-event timings."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]


def traced_kernel(torch, op, name, calls=10, pad=256, tries=3):
    """Device records of ``calls`` calls of ``op`` in one profiler trace:
    (durations in ns of the kernels named ``name``, of the other device
    records).  After a large trace the profiler drops the device records
    of whole runs of launches at a trace's start and end (in this
    script's H100 runs four to six of ten launches as a rule, all ten
    once; the host's launch records stay), so ``pad`` spin
    kernels on each side take the loss and are not counted, and a trace
    that still kept no ``name`` kernel is taken again, up to ``tries``
    traces in all."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(pad):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            for _ in range(calls):
                op()
            torch.cuda.synchronize()
            for _ in range(pad):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
        on_dev = [e for e in prof.profiler.kineto_results.events()
                  if e.device_type() == DeviceType.CUDA
                  and "spin_kernel" not in e.name()]
        mine = [e.duration_ns() for e in on_dev if name in e.name()]
        if mine:
            break
    others = [e.duration_ns() for e in on_dev if name not in e.name()]
    return mine, others


def bound(nbytes, nops, peak_ops=FP32_OPS):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = nops / peak_ops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


# ---- checks scaled to the instance -----------------------------------------
# A kernel's θ is held against its plain version per row in units of the
# row's mean allocation over active jobs, b / k_act.  K1 and K2 rescale θ
# onto b before they return, so their row sums prove nothing; their KKT
# conditions do: c_i / s_i'(θ_i) is one value (1/λ) over the jobs with
# 0 < θ_i < b, and a parked job has c_i λ ≥ s_i'(0).  K3 does not rescale,
# so its budget miss counts.  The limits sit between the readings of the
# sound kernels and those of planted faults: the kernel run with its
# bisection cut to SHORT_ITERS steps, and the sound kernel's θ with a
# parking threshold at 0.9·s'(0) or each allocation one slot late.  Each
# run prints both and fails unless every sound reading is within its
# limits and every fault is beyond one.  K2's allocation limit is wider:
# its saturating jobs compute θ = z − (y/A)^{1/γ} with z up to 80, which
# leaves about 1e-4 of float32 rounding in θ, its plain version's too.
ALLOC_LIMIT = {"K1": 1e-2, "K2": 1e-1, "K3": 1e-2}  # max |Δθ| / (b/k_act)
KKT_LIMIT = 1e-4        # ratio spread, parking shortfall (relative)
SUM_LIMIT = 1e-5        # K3: |Σθ − b| / b
SHORT_ITERS = 16        # the planted fault: a bisection cut to 16 steps


def alloc_err(theta, ref, scale):
    """max over rows of max_i |θ − ref| / scale (scale per row, or one)."""
    d = (theta.double() - ref.double()).abs()
    if d.ndim == 1:
        return float(d.max() / scale)
    return float((d.amax(-1) / scale).max())


def interior(th, active, b):
    """Active jobs strictly between 0 and the cap b, where s'(θ) = λc
    holds; a job the kernels' final rescale moved just under a cap of b
    is still at the cap."""
    return active & (th > 0) & (th < b * (1.0 - 1e-4))


def kkt_residual(theta, c, A, w, g, s, b):
    """(ratio spread, parking shortfall), each the max over rows, of a
    batched CAP solution θ (N, K) for s_i'(θ) = A_i (w_i + σ_i θ)^γ_i."""
    import torch
    th, c, A, w, g, s = (torch.broadcast_to(x.double(), theta.shape)
                         for x in (theta, c, A, w, g, s))
    bk = b.double()[:, None]
    active = c > 0
    pos = interior(th, active, bk)
    ratio = c / (A * torch.clamp_min(w + s * th, 1e-300) ** g)
    r_max = torch.where(pos, ratio, -torch.inf).amax(-1)
    r_min = torch.where(pos, ratio, torch.inf).amin(-1)
    has = pos.any(-1)
    spread = torch.where(has, (r_max - r_min) / r_max, 0.0)
    ds0 = torch.where(w > 0, A * torch.clamp_min(w, 1e-300) ** g, torch.inf)
    short = torch.where(active & (th == 0) & has[:, None],
                        torch.clamp_min(1.0 - (c / ds0) / r_min[:, None], 0.0),
                        0.0).amax(-1)
    return float(spread.max()), float(short.max())


def level_of(theta, u, h0, b):
    """The median level h0_i + θ_i/u_i of the bottles with 0 < θ_i < b."""
    th, u, h0 = theta.double(), u.double(), h0.double()
    pos = interior(th, u > 0, b)
    return float((h0 + th / u.clamp_min(1e-30))[pos].median())


def level_residual(theta, u, h0, b):
    """(level spread, parking shortfall, budget miss) of a level-WFP θ,
    the first two in units of the mean allocation b / m_act: every bottle
    with 0 < θ_i < b fills to one level h, and a parked bottle has
    h0_i ≥ h.  Without a bottle strictly inside (0, b) there is no level
    to read, and only the budget counts."""
    import torch
    th, u, h0 = theta.double(), u.double(), h0.double()
    active = u > 0
    pos = interior(th, active, b)
    if not bool(pos.any()):
        return 0.0, 0.0, float(abs(th.sum() - b) / b)
    unit = b / float(active.sum())
    h = level_of(th, u, h0, b)
    lev = h0 + th / u.clamp_min(1e-30)
    spread = float(torch.where(pos, u * (lev - h).abs(), 0.0).max()) / unit
    short = float(torch.where(active & (th == 0),
                              torch.clamp_min(u * (h - h0), 0.0),
                              0.0).max()) / unit
    return spread, short, float(abs(th.sum() - b) / b)


def planted_faults(theta, c, A, w, g, s, b, short):
    """Three wrong answers of K1 or K2 beside the sound θ (N, K): the
    kernel's θ with its bisection cut short (``short``, run by the
    caller), with a parking threshold at 0.9·s_i'(0) (then rescaled onto
    b, as the kernels do), and with each allocation one slot late."""
    import torch
    th, c, A, w, g, s = (torch.broadcast_to(x.double(), theta.shape)
                         for x in (theta, c, A, w, g, s))
    bk = b.double()[:, None]
    active = c > 0
    pos = interior(th, active, bk)
    lam = (torch.where(pos, A * torch.clamp_min(w + s * th, 1e-300) ** g / c,
                       0.0).sum(-1) / pos.sum(-1).clamp_min(1))[:, None]
    ds0 = torch.where(w > 0, A * torch.clamp_min(w, 1e-300) ** g, torch.inf)
    parked = torch.where(c * lam >= 0.9 * ds0, 0.0, th)
    tot = parked.sum(-1, keepdim=True)
    parked = torch.where(tot > 0, parked * (bk / tot), parked)
    late = torch.where(active, torch.roll(th, 1, dims=-1), 0.0)
    return {"cut_short": short, "park_0.9": parked, "one_slot_late": late}


def cap_instance(rng, N_, K_, b_lo, b_hi, kinds=3):
    """A batched CAP instance from ``rng``: c (N_, K_) with a random
    prefix of at least half the jobs active, sorted descending in
    [0.01, 1]; budgets b evenly from b_lo to b_hi; and per-job families
    (A, w, γ, σ), each job a power, a log or a saturating speedup (the
    first ``kinds`` of the three) with z_sat in [b_hi, 2 b_hi]."""
    import numpy as np
    C = np.zeros((N_, K_))
    for n in range(N_):
        k = int(rng.integers(max(K_ // 2, 1), K_ + 1))
        C[n, :k] = np.sort(rng.uniform(0.01, 1.0, k))[::-1]
    b = np.linspace(b_lo, b_hi, N_)
    fam = rng.integers(0, kinds, (N_, K_))       # 0 power, 1 log, 2 satur.
    a_ = rng.uniform(0.5, 2.0, (N_, K_))
    p_pow = rng.uniform(0.3, 0.8, (N_, K_))
    p_log = rng.uniform(0.5, 2.0, (N_, K_))
    p_sat = rng.uniform(1.5, 3.0, (N_, K_))
    z_sat = rng.uniform(b_hi, 2.0 * b_hi, (N_, K_))   # z ≥ the largest b
    A_mix = np.where(fam == 0, a_ * p_pow, np.where(fam == 1, a_,
                                                    a_ * p_sat))
    w_mix = np.where(fam == 0, 0.0, np.where(fam == 1, 1.0 / p_log, z_sat))
    g_mix = np.where(fam == 0, p_pow - 1.0, np.where(fam == 1, -1.0,
                                                     p_sat - 1.0))
    s_mix = np.where(fam == 2, -1.0, 1.0)
    return C, b, (A_mix, w_mix, g_mix, s_mix)


# K1 and K2 on the shapes and options that test their job tiles and
# in-kernel bracket: (kernel, shared family or "mix", N, K, b from, b to,
# first row without an active job).  K = 1 and 37 take part of one
# register-tile slot; 5000 puts 904 jobs in shared memory; 65536 (N = 4)
# streams about 50,000 jobs a pass; N = 1; and b = 1e-3 on pure powers,
# whose θ = 2^t keeps its relative precision at any scale.  K1's families
# are shared by every instance: shifted power (phase 3's), a pure power
# (w = 0, the s'(ε) end of the bracket) and a saturating one (σ = −1,
# b < z: at b = z, s'(b) = 0 and the bracket degenerates in both
# versions).  Where a job's θ = z − 2^t, both versions round θ to
# float32's spacing at z, so the b ranges keep b/k_act well above it, as
# phase 3 does; the limits are phase 3's.  The bisection cut to
# SHORT_ITERS steps must fail the checks wherever the plain version cut
# as short does (not where a 16-step bracket is already within them: few
# jobs, or one pure power shared by a row, whose θ ∝ λ^{1/γ} the rescale
# undoes).
CAP_FAMILIES = {"shifted": (0.5, 4.0, -0.5, 1), "power": (0.5, 0.0, -0.5, 1),
                "saturating": (2.0, 10.0, 1.0, -1)}
CAP_OPTIONS = {
    "K1_power_w0": ("K1", "power", 64, 4096, 1.0, 40.0, False),
    "K1_saturating": ("K1", "saturating", 64, 512, 4.0, 8.0, False),
    "K1_K1": ("K1", "shifted", 8, 1, 1.0, 40.0, False),
    "K1_K37_empty_row": ("K1", "shifted", 16, 37, 1.0, 40.0, True),
    "K1_K5000": ("K1", "shifted", 16, 5000, 10.0, 40.0, False),
    "K1_K65536": ("K1", "shifted", 4, 65536, 10.0, 40.0, False),
    "K1_N1": ("K1", "shifted", 1, 4096, 20.0, 20.0, False),
    "K1_b_1e-3": ("K1", "power", 16, 4096, 1e-3, 1e-3, False),
    "K2_K1": ("K2", "mix", 8, 1, 1.0, 40.0, False),
    "K2_K37_empty_row": ("K2", "mix", 16, 37, 1.0, 40.0, True),
    "K2_K5000": ("K2", "mix", 16, 5000, 10.0, 40.0, False),
    "K2_K65536": ("K2", "mix", 4, 65536, 35.0, 40.0, False),
    "K2_N1": ("K2", "mix", 1, 4096, 20.0, 20.0, False),
    "K2_b_1e-3": ("K2", "power_mix", 16, 4096, 1e-3, 1e-3, False),
}


def dtype_rule_phase(torch, sp, b, c, active):
    """Phase 3, continued: ``impl="auto"`` on float64 CUDA input takes
    the float64 closed form, not the float32 kernel: the output stays
    float64, no kernel is launched, and it is the closed form's to
    1e-12 relative.  Times both dtypes' auto calls."""
    from repro_torch.core import solve_cap_batched, solve_cap_regular
    from repro_torch.kernels.gwf_waterfill import kernel as wk

    b64, c64 = b.double(), c.double()
    before = dict(wk.LAUNCHES)
    th = solve_cap_batched(sp, b64, c64, active, impl="auto", iters=ITERS)
    torch.cuda.synchronize()
    check(dict(wk.LAUNCHES) == before,
          f"a float64 auto call launched a kernel: {before} → {wk.LAUNCHES}")
    check(th.is_cuda and th.dtype == torch.float64 and th.shape == c.shape,
          f"float64 auto output {th.dtype} {tuple(th.shape)} on {th.device}")
    closed = solve_cap_regular(sp, b64, c64, active)
    nz = closed != 0
    rel = float(((th - closed).abs()[nz] / closed.abs()[nz]).max())
    check(rel <= 1e-12 and bool((th[~nz] == 0).all()),
          f"float64 auto vs the closed form: {rel:.3e} > 1e-12")
    ms64 = timed(torch, lambda: solve_cap_batched(sp, b64, c64, active,
                                                  impl="auto", iters=ITERS))
    ms32 = timed(torch, lambda: solve_cap_batched(sp, b, c, active,
                                                  impl="auto", iters=ITERS))
    emit({"phase": "cap_dtype_rule", "N": int(c.shape[0]),
          "k": int(c.shape[1]), "f64_dtype": str(th.dtype),
          "f64_vs_closed_rel": rel, "f64_launches": 0,
          "f64_auto_ms": ms64, "f32_auto_ms": ms32})


def cap_options_phase(torch, dev):
    """Phase 3, continued: K1 and K2 against their plain versions on
    ``CAP_OPTIONS``, in units of b/k_act and by their KKT conditions, with
    the bisection cut to SHORT_ITERS steps as the planted fault."""
    import numpy as np
    from repro_torch.kernels.gwf_waterfill import kernel as wk
    from repro_torch.kernels.gwf_waterfill import ref as wr

    got = {}
    for i, (name, (kern, fam, N_, K_, b_lo, b_hi, empty)) in \
            enumerate(CAP_OPTIONS.items()):
        rng = np.random.default_rng(100 + i)
        C, b, mix = cap_instance(rng, N_, K_, b_lo, b_hi,
                                 kinds=1 if fam == "power_mix" else 3)
        if empty:
            C[0] = 0.0
        c = torch.tensor(C, dtype=torch.float32, device=dev)
        bd = torch.tensor(b, dtype=torch.float32, device=dev)
        if kern == "K1":
            A, w, g, sig = CAP_FAMILIES[fam]
            params = [torch.tensor(float(x), device=dev)
                      for x in (A, w, g, sig)]

            def run(iters, fn=wk.generic_waterfill):
                return fn(c, A, w, g, bd, sigma=sig, iters=iters)
            plain_fn = wr.generic_waterfill_ref
        else:
            params = [torch.tensor(x, dtype=torch.float32, device=dev)
                      for x in mix]

            def run(iters, fn=wk.hetero_waterfill):
                return fn(c, *params, bd, iters=iters)
            plain_fn = wr.hetero_waterfill_ref
        plain = run(ITERS, plain_fn)
        scale = bd.double() / (c > 0).sum(1).clamp_min(1).double()
        lim = ALLOC_LIMIT[kern]

        def readings(th):
            r = {"alloc": alloc_err(th, plain, scale)}
            r["kkt_spread"], r["kkt_park"] = kkt_residual(th, c, *params, bd)
            r["bad"] = (r["alloc"] > lim
                        or max(r["kkt_spread"], r["kkt_park"]) > KKT_LIMIT)
            return r

        th = run(ITERS)
        r = readings(th)
        r["fault_cut_short"] = readings(run(SHORT_ITERS))
        r["plain_cut_short"] = readings(run(SHORT_ITERS, plain_fn))
        r["inactive_zero"] = bool((th[c <= 0] == 0).all())
        r["finite"] = bool(torch.isfinite(th).all())
        got[name] = r
        check(r["finite"] and r["inactive_zero"] and not r["bad"],
              f"{name}: readings {r} beyond alloc {lim}, KKT {KKT_LIMIT}")
        check(r["fault_cut_short"]["bad"] or not r["plain_cut_short"]["bad"],
              f"{name}: the bisection cut short passes the checks, the "
              f"plain version cut as short does not: {r}")
    emit({"phase": "cap_options",
          "limits": {"alloc": ALLOC_LIMIT, "kkt": KKT_LIMIT},
          "readings": got})


def level_bottles(torch, c3, dev):
    """Phase 4's bottles from its c (K,), sorted descending: the shifted
    power's widths u and bottoms h0 in float32, the last quarter inactive
    (u = h0 = 0).  Returns (active, u, h0)."""
    from repro_torch.core import shifted_power
    sp3 = shifted_power(1.0, 4.0, 0.5, B, device=dev, dtype=torch.float32)
    c3d = torch.tensor(c3, dtype=torch.float32, device=dev)
    act3 = torch.arange(len(c3), device=dev) < 3 * len(c3) // 4
    return (act3,
            torch.where(act3, sp3.bottle_width(c3d), 0.0).contiguous(),
            torch.where(act3, sp3.bottle_bottom(c3d), 0.0).contiguous())


def fixed_point_steps(run, full):
    """The smallest ``iters`` at which ``run(iters)`` gives the bits of
    ``full`` (K3 at ITERS steps): the steps the bisection takes to its
    float32 fixed point, or ITERS if it has none within them."""
    import torch
    bits = full.view(torch.int32)
    return next((n for n in range(1, ITERS)
                 if torch.equal(run(n).view(torch.int32), bits)), ITERS)


# K3 on the shapes and options that test its bottle tiles, bracket and
# exit: name → (M, b, bottles).  M = 1 and 37 take part of one
# register-tile slot; 5000 puts 904 bottles in shared memory; 65536
# streams 36,864 bottles a round.  "random" is the JAX kernel test's
# instance (u in [0.1, 5], h0 in [−2, 3], a quarter inactive);
# "one_active" and "none_active" keep one bottle active or none (θ = 0,
# the plain version's zeros); "at_b_scale" has bottoms in b·[−2, 3]: a
# reading in units of b/m_act compares θ's error with the mean
# allocation, and θ_i = u_i (h − h0_i) carries float32's spacing at h,
# which with b = 1e-3 and a level near 1 is about a unit itself in both
# versions (the plain version in float32 is that far from itself in
# float64), so the bottoms follow b's scale; "level_at_0" has bottoms of
# both signs shifted so that the level sits at 0, where float32 is
# finest and the bisection takes the most steps.  The limits are
# level_wfp's.  The bisection cut to SHORT_ITERS steps is read but not
# required to fail: with one active bottle a 16-step bracket misses b by
# less than SUM_LIMIT.
K3_OPTIONS = {
    "M1": (1, 10.0, "one_active"),
    "M37": (37, 10.0, "random"),
    "M4096": (4096, 200.0, "random"),
    "M5000": (5000, 200.0, "random"),
    "M65536": (65536, 200.0, "random"),
    "one_active": (4096, 10.0, "one_active"),
    "none_active": (4096, 10.0, "none_active"),
    "b_1e-3": (4096, 1e-3, "at_b_scale"),
    "level_at_0": (4096, 50.0, "level_at_0"),
}


def level_instance(torch, rng, M, b, kind, dev):
    """Bottles (u, h0), float32 on ``dev``, of a ``K3_OPTIONS`` kind."""
    import numpy as np
    from repro_torch.kernels.gwf_waterfill.ref import gwf_waterfill_ref
    u = rng.uniform(0.1, 5.0, M)
    h0 = rng.uniform(-2.0, 3.0, M)
    if kind == "random":
        u[rng.random(M) < 0.25] = 0.0
    elif kind == "one_active":
        u[1:] = 0.0
    elif kind == "none_active":
        u[:] = 0.0
    elif kind == "at_b_scale":
        h0 *= b
    else:                                         # level_at_0
        h0 = rng.uniform(-1.0, 1.0, M)
        ud, hd = (torch.tensor(x, device=dev) for x in (u, h0))
        th = gwf_waterfill_ref(ud, hd, b)
        h0 = h0 - level_of(th, ud, hd, b)
    return (torch.tensor(np.asarray(x, np.float32), device=dev)
            for x in (u, h0))


def k3_options_phase(torch, dev):
    """Phase 4, continued: K3 against its plain version on
    ``K3_OPTIONS`` at level_wfp's limits (in units of b/m_act, the
    level, the budget), the plain version in float32 against itself in
    float64 beside it, and the steps to the fixed point."""
    import numpy as np
    from repro_torch.kernels.gwf_waterfill import kernel as wk
    from repro_torch.kernels.gwf_waterfill.ref import gwf_waterfill_ref

    got = {}
    for i, (name, (M, b, kind)) in enumerate(K3_OPTIONS.items()):
        rng = np.random.default_rng(200 + i)
        u, h0 = level_instance(torch, rng, M, b, kind, dev)

        def run(iters):
            return wk.gwf_waterfill(u, h0, b, iters=iters)
        th = run(ITERS)
        plain = gwf_waterfill_ref(u, h0, b)
        active = u > 0
        r = {"finite": bool(torch.isfinite(th).all()),
             "inactive_zero": bool((th[~active] == 0).all()),
             "fixed_point_steps": fixed_point_steps(run, th)}
        if kind == "none_active":
            r["zeros"] = bool((th == 0).all() and (plain == 0).all())
            got[name] = r
            check(r["finite"] and r["zeros"],
                  f"K3 {name}: θ is not zero without an active bottle: {r}")
            continue
        unit = b / float(active.sum())
        plain64 = gwf_waterfill_ref(u.double(), h0.double(), b)

        def readings(t):
            f = {"alloc": alloc_err(t, plain, unit)}
            f["level_spread"], f["level_park"], f["sum"] = level_residual(
                t, u, h0, b)
            f["bad"] = (f["alloc"] > ALLOC_LIMIT["K3"]
                        or f["sum"] > SUM_LIMIT
                        or max(f["level_spread"], f["level_park"])
                        > KKT_LIMIT)
            return f
        r.update(readings(th))
        r["plain_vs_plain_f64"] = alloc_err(plain, plain64, unit)
        r["fault_cut_short"] = readings(run(SHORT_ITERS))
        got[name] = r
        check(r["finite"] and r["inactive_zero"] and not r["bad"],
              f"K3 {name}: readings {r} beyond alloc {ALLOC_LIMIT['K3']}, "
              f"level {KKT_LIMIT}, budget {SUM_LIMIT}")
    emit({"phase": "k3_options",
          "limits": {"alloc": ALLOC_LIMIT["K3"], "level": KKT_LIMIT,
                     "sum": SUM_LIMIT},
          "threads": wk.THREADS["gwf_waterfill"], "readings": got})


# ---- the serving path: K4 and K5 ---------------------------------------------
# Readings of a kernel against its plain version on the same inputs.  In
# f32 (the point is the kernel) in units of the plain output's RMS: one
# key more or less in a 2048-key window moves an output by ~1/2048 of its
# scale, which a bf16-sized tolerance would pass.  In bf16 relative to
# |plain| + its RMS, a wider check: both round their outputs to bf16,
# and K5 also rounds p to bf16 before p·V (as both JAX versions do) where
# its plain version keeps p in f32, which in the first rows (a few keys
# whose terms cancel) moves an output by a few per cent of itself.  The
# f32 limits sit between the sound readings and those of planted faults,
# which each run prints and requires over them.
K5_F32_LIMIT = 1e-3
K4_F32_LIMIT = 1e-4
BF16_LIMIT = 1e-1
# K5's bf16 instantiation (tensor cores, p rounded to bf16) against the
# f32 plain output of the same bf16 inputs, in units of that output's
# RMS; planted faults run through the bf16 kernel must read over it.  At
# the serving shape the sound reading is half a bf16 ulp of the largest
# output (0.0078 at |o| in [2, 4), 0.14 RMS units), which the plain
# version rounded to bf16 reads too; the faults read 0.32–1.8.
K5_BF16_RMS_LIMIT = 0.2
# End to end, logits max |Δ| in units of the plain run's std.  In bf16 the
# reading is about one bf16 ulp of the largest logit, and with random
# weights the attention branch adds too little to the logits for a
# wrong window or tile to show above that; the same weights in f32 show
# every planted fault of K4 and K5.
E2E_BF16_LIMIT = 0.5
E2E_F32_LIMIT = 2e-4


def rms_err(out, ref):
    """max |out − ref| over the RMS of ref."""
    ref = ref.double()
    return float((out.double() - ref).abs().max() / ref.pow(2).mean().sqrt())


def rel_rms(out, ref):
    """RMS of out − ref over the RMS of ref."""
    ref = ref.double()
    return float((out.double() - ref).pow(2).mean().sqrt()
                 / ref.pow(2).mean().sqrt())


def rel_err(out, ref):
    """max |out − ref| / (|ref| + RMS of ref)."""
    ref = ref.double()
    rms = ref.pow(2).mean().sqrt()
    return float(((out.double() - ref).abs() / (ref.abs() + rms)).max())


# Planted faults of K4 and K5, each a wrong kernel with the op's calling
# convention, so the end-to-end phase can put one in the model's place.
# Phase 8 reads them at the kernel, phase 9 through the whole model.
def scan_carry_reset_halfway(a, b):
    import torch
    from repro_torch.kernels.linear_scan.kernel import linear_scan
    h = a.shape[1] // 2
    return torch.cat([linear_scan(a[:, i:j].contiguous(),
                                  b[:, i:j].contiguous())
                      for i, j in ((0, h), (h, a.shape[1]))], dim=1)


def scan_step_one_slot_late(a, b):
    from repro_torch.kernels.linear_scan.kernel import linear_scan
    late = b.roll(1, dims=1)
    late[:, 0] = 0
    return linear_scan(a, late)


def scan_without_carry(a, b):
    from repro_torch.kernels.linear_scan.kernel import linear_scan
    return linear_scan(a * 0, b)


def attn_window_plus_1(q, k, v, causal=True, window=None, cap=None):
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    return flash_attention(q, k, v, causal=causal, window=window + 1,
                           cap=cap)


def attn_dropped_last_kv_tile(q, k, v, causal=True, window=None, cap=None):
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    T = k.shape[1] - 64
    return flash_attention(q, k[:, :T].contiguous(), v[:, :T].contiguous(),
                           causal=causal, window=window, cap=cap)


def attn_causal_off(q, k, v, causal=True, window=None, cap=None):
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    return flash_attention(q, k, v, causal=False, window=window, cap=cap)


SCAN_FAULTS = {"carry_reset_halfway": scan_carry_reset_halfway,
               "step_one_slot_late": scan_step_one_slot_late,
               "no_carry": scan_without_carry}
ATTN_FAULTS = {"window_plus_1": attn_window_plus_1,
               "dropped_last_kv_tile": attn_dropped_last_kv_tile,
               "causal_off": attn_causal_off}


def serve_taps(arch, cfg):
    """Where ``serve_phase`` taps wave 0's kernel inputs for the later
    checks: cap key → (module, attribute, calls kept)."""
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import rglru as rglru_mod
    from repro_torch.models import scan_ops
    if arch == MAMBA_ARCH:      # the first layer's first two chunks
        return {"chunks": (scan_ops, "_scan_folded", 2)}
    # the first K5 call; in an encoder–decoder every encoder layer's,
    # then the first decoder layer's self- and cross-attention
    n = cfg.n_enc_layers + 2 if cfg.encoder_decoder else 1
    taps = {"qkv": (attn_mod, "flash_attention_op", n)}
    if "rglru" in cfg.cycle:
        taps["ab"] = (rglru_mod, "linear_scan_op", 1)
    return taps


def serve_shape(cfg):
    """(prompt tokens, patches, frames) of a wave of ``cfg``: the VLM's
    patches and its tokens fill ``PROMPT`` positions; the encoder–decoder
    reads ``ENCDEC_FRAMES`` frames behind an ``ENCDEC_PROMPT``-token
    decoder prompt."""
    if cfg.family == "vlm":
        return PROMPT - cfg.n_patches, cfg.n_patches, 0
    if cfg.encoder_decoder:
        return ENCDEC_PROMPT, 0, ENCDEC_FRAMES
    return PROMPT, 0, 0


def cache_len(batch):
    """Decode caches for ``batch``: its patches, its tokens and GEN."""
    n = batch["patches"].shape[1] if "patches" in batch else 0
    return n + batch["tokens"].shape[1] + GEN


def route_recorder(torch, cap, on):
    """A stand-in for ``models.moe._router`` that appends each call's
    top-k expert indices (uint8, on the card) to ``cap`` while ``on()``."""
    from repro_torch.models import moe as moe_mod
    router = moe_mod._router

    def run(*args, **kw):
        top_p, top_i, aux = router(*args, **kw)
        if on():
            cap.append(top_i.to(torch.uint8))
        return top_p, top_i, aux
    return mock.patch.object(moe_mod, "_router", run)


def serve_phase(torch, np, dev, arch=ARCH, waves=WAVES, expect=None,
                prefix="serve", cfg=None):
    """Phase 7 (and 16(b), 17): ``arch`` at full width (or ``cfg``, a cut
    of it) serves ``waves`` waves of ``serve_shape``.  ``expect`` maps a
    kernel to (launches a prefill, exact?); by default K5 at least once a
    local layer and K4 once an RG-LRU layer.  Lines are
    ``<prefix>_model``, ``<prefix>_wave`` and ``<prefix>_main_path``.
    Returns the model, wave 0's batch and tokens, its captures (the
    logits, the kernel inputs of ``serve_taps``, every K5 call's
    (causal, S, T) in ``qkv_calls`` and, for a MoE, each router call's
    top-k in ``routes``) and the launches of all waves."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.linear_scan import kernel as sk
    from repro_torch.models import init_params
    from repro_torch.models.moe import MoE
    from repro_torch.serve import ServeEngine

    cfg = cfg or get_config(arch)
    kinds = cfg.layer_kinds()
    if expect is None:
        expect = {"flash_attention": (kinds.count("local"), False),
                  "linear_scan": (kinds.count("rglru"), False)}
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    torch.cuda.synchronize()
    emit({"phase": f"{prefix}_model", "arch": cfg.name, "dtype": cfg.dtype,
          "params": sum(p.numel() for p in model.parameters()),
          "param_count": cfg.param_count(),
          "layers": {k: kinds.count(k) for k in sorted(set(kinds))},
          "encoder_layers": len(model.enc_layers),
          "weights_gb": torch.cuda.memory_allocated() / 1e9,
          "init_s": time.perf_counter() - t0})
    rng = np.random.default_rng(0)
    n_tok, n_patch, n_frame = serve_shape(cfg)
    batches = [{"tokens": rng.integers(2, cfg.vocab, (BATCH, n_tok))}
               for _ in range(waves)]
    for batch in batches:
        if n_patch:
            batch["patches"] = rng.standard_normal(
                (BATCH, n_patch, cfg.patch_dim)).astype(np.float32)
        if n_frame:
            batch["frames"] = rng.standard_normal(
                (BATCH, n_frame, cfg.patch_dim)).astype(np.float32)
    eng = ServeEngine(model=model, max_len=cache_len(batches[0]))

    # time each wave's prefill and decode with CUDA events (no host
    # sync inside generate), count K4/K5 launches per prefill, and keep
    # wave 0's logits and the tapped kernel inputs (copies: a tap's
    # callee may overwrite them)
    taps = serve_taps(arch, cfg)
    cap = {"logits": [], "qkv_calls": [], "routes": [],
           **{key: [] for key in taps}}
    marks, per_prefill = [], []
    prefill0, step0 = eng._prefill, eng._step

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def prefill(batch):
        before = (fk.LAUNCHES["flash_attention"], sk.LAUNCHES["linear_scan"])
        marks.append([event()])
        logits, state = prefill0(batch)
        marks[-1].append(event())
        per_prefill.append((fk.LAUNCHES["flash_attention"] - before[0],
                            sk.LAUNCHES["linear_scan"] - before[1]))
        if len(marks) == 1:
            cap["logits"].append(logits)
        return logits, state

    def step(tok, state):
        logits, state = step0(tok, state)
        marks[-1].append(event())
        if len(marks) == 1:
            cap["logits"].append(logits)
        return logits, state

    def tap(key, fn, n):
        def run(*args, **kw):
            if len(marks) == 1:
                if key == "qkv":
                    cap["qkv_calls"].append((bool(kw.get("causal", True)),
                                             args[0].shape[1],
                                             args[1].shape[1]))
                if len(cap[key]) < n:
                    cap[key].append((
                        tuple(a.clone() if isinstance(a, torch.Tensor)
                              else a for a in args), dict(kw)))
            return fn(*args, **kw)
        return run

    eng._prefill, eng._step = prefill, step
    torch.cuda.synchronize()
    outs = []
    fk.reset_launches()
    sk.reset_launches()
    with contextlib.ExitStack() as stack:
        for key, (mod, attr, n) in taps.items():
            stack.enter_context(mock.patch.object(
                mod, attr, tap(key, getattr(mod, attr), n)))
        if cfg.moe:
            stack.enter_context(route_recorder(torch, cap["routes"],
                                               lambda: len(marks) == 1))
        for w in range(waves):
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = eng.generate(batches[w], GEN)
            wall = time.perf_counter() - t0
            ev = marks[w]
            outs.append(out)
            emit({"phase": f"{prefix}_wave", "wave": w,
                  "prefill_ms": ev[0].elapsed_time(ev[1]),
                  "decode_ms_per_token": ev[1].elapsed_time(ev[-1])
                  / (GEN - 1),
                  "tokens_per_s": out.size / wall,
                  "prompt_tokens_per_s": BATCH * (n_tok + n_patch) / wall,
                  "wall_s": wall,
                  "max_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
                  "launches_K5_K4": per_prefill[w],
                  "first_tokens": out[:, :4].tolist()})
    launches = {"flash_attention": fk.LAUNCHES["flash_attention"],
                "linear_scan": sk.LAUNCHES["linear_scan"]}
    emit({"phase": f"{prefix}_main_path", "launches": launches,
          "per_prefill": per_prefill,
          "expected_per_prefill": {k: list(v) for k, v in expect.items()}})
    for w, counts in enumerate(per_prefill):
        for (name, (n, exact)), got in zip(
                (("flash_attention", expect["flash_attention"]),
                 ("linear_scan", expect["linear_scan"])), counts):
            check(got == n if exact else got >= n,
                  f"{arch}: wave {w}'s prefill launched {name} {got}× "
                  f"({'exactly' if exact else 'at least'} {n} expected)")
    for out in outs:
        check(out.shape == (BATCH, GEN) and out.dtype == np.int32
              and bool(((out >= 0) & (out < cfg.vocab)).all()),
              f"generated tokens out of shape or range: {out.shape}")
    check(len(cap["logits"]) == GEN, "wave 0's logits were not all kept")
    for lg in cap["logits"]:
        check(lg.shape == (BATCH, cfg.vocab) and bool(torch.isfinite(lg).all()),
              "non-finite or misshapen logits in wave 0")
    for key, (_, _, n) in taps.items():
        check(len(cap[key]) == n,
              f"wave 0's kernel inputs {key!r} were not captured")
    if cfg.moe:
        n_moe = sum(isinstance(b.mlp, MoE) for b in model.layers)
        check(len(cap["routes"]) == GEN * n_moe,
              f"wave 0's routes: {len(cap['routes'])} router calls, "
              f"{GEN * n_moe} expected")
    return model, batches[0], outs[0], cap, launches


def kernel_phase(torch, cap):
    """Phase 8: K5 and K4 against their plain versions at the path's
    shapes, on wave 0's own inputs, with planted faults."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.linear_scan import kernel as sk
    from repro_torch.kernels.linear_scan.ref import linear_scan_ref

    (q, k, v), kw = cap["qkv"][0]
    kw = {n: kw[n] for n in ("causal", "window", "cap")}
    check(kw["causal"] and kw["window"] is not None,
          f"the first local layer's attention is not a causal window: {kw}")
    q32, k32, v32 = q.float(), k.float(), v.float()
    plain = attention_ref(q32, k32, v32, **kw)
    r5 = {"f32_rms_units": rms_err(fk.flash_attention(q32, k32, v32, **kw),
                                   plain)}
    out16 = fk.flash_attention(q, k, v, **kw)
    plain16 = attention_ref(q, k, v, **kw)
    r5["bf16_rel"] = rel_err(out16, plain16)
    r5["bf16_max_abs"] = float((out16.float() - plain16.float()).abs().max())
    r5["bf16_rms_units"] = rms_err(out16, plain)
    r5["plain_bf16_rms_units"] = rms_err(plain16, plain)
    for dt, (qi, ki, vi) in (("", (q32, k32, v32)), ("bf16_", (q, k, v))):
        sound = out16 if dt else fk.flash_attention(q32, k32, v32, **kw)
        for name, fault in ATTN_FAULTS.items():
            wrong = fault(qi, ki, vi, **kw)
            if name == "causal_off":          # one q tile past the window
                r0 = kw["window"]
                wrong, rows = sound.clone(), wrong
                wrong[:, r0:r0 + 64] = rows[:, r0:r0 + 64]
                name = "causal_off_one_tile"
            r5[f"{dt}fault_{name}"] = rms_err(wrong, plain)

    a, b = cap["ab"][0][0][:2]
    plain4 = linear_scan_ref(a, b)
    sound4 = sk.linear_scan(a, b)
    r4 = {"f32_rms_units": rms_err(sound4, plain4),
          "f32_max_abs": float((sound4 - plain4).abs().max())}
    a16, b16 = a.bfloat16(), b.bfloat16()
    r4["bf16_rel"] = rel_err(sk.linear_scan(a16, b16),
                             linear_scan_ref(a16, b16))
    for name in ("carry_reset_halfway", "step_one_slot_late"):
        r4[f"fault_{name}"] = rms_err(SCAN_FAULTS[name](a, b), plain4)
    torch.cuda.synchronize()
    emit({"phase": "serve_kernels", "K5_shape": {"q": list(q.shape),
                                                 "kv": list(k.shape), **kw},
          "K4_shape": list(a.shape),
          "limits": {"K5_f32": K5_F32_LIMIT, "K4_f32": K4_F32_LIMIT,
                     "bf16": BF16_LIMIT, "K5_bf16_rms": K5_BF16_RMS_LIMIT},
          "K5": r5, "K4": r4})
    for name, r, lim in (("K5", r5, K5_F32_LIMIT), ("K4", r4, K4_F32_LIMIT)):
        check(r["f32_rms_units"] <= lim,
              f"{name} vs plain in f32: {r['f32_rms_units']:.3e} > {lim}")
        check(r["bf16_rel"] <= BF16_LIMIT,
              f"{name} vs plain in bf16: {r['bf16_rel']:.3e} > {BF16_LIMIT}")
        for key, val in r.items():
            if key.startswith("fault_"):
                check(val > lim, f"{name}: the planted fault {key} reads "
                                 f"{val:.3e}, within the limit {lim}")
    check(r5["bf16_rms_units"] <= K5_BF16_RMS_LIMIT,
          f"K5 bf16 vs f32 plain: {r5['bf16_rms_units']:.3e} > "
          f"{K5_BF16_RMS_LIMIT} RMS units")
    for key, val in r5.items():
        if key.startswith("bf16_fault_"):
            check(val > K5_BF16_RMS_LIMIT, f"K5: the planted fault {key} "
                  f"reads {val:.3e}, within {K5_BF16_RMS_LIMIT}")
    return {"flash_attention": r5["bf16_max_abs"],
            "linear_scan": r4["f32_max_abs"]}


# K5's other option sets, those of the dense configs and of the wrapper's
# edges: (B, S, T, H, K, hd), causal, window, cap.  Ragged S and T (not
# multiples of the 64-row tiles), gemma2's softcap 50 with and without
# its window, grouped-query attention with 4 q heads per kv head at hd
# 64 (llama3.2) and 128, multi-head at hd 128 (qwen1.5, deepseek), a
# cross-length unmasked call, an hd that is no power of two, an hd whose
# rows are not whole 16-byte pieces (the kernel's element copies in both
# dtypes), and rows that have no unmasked key (a window, S ≥ T + window),
# whose plain softmax is uniform over all T keys.
K5_OPTIONS = {
    "gemma2_local_cap50": ((1, 1000, 1000, 4, 2, 128), True, 300, 50.0),
    "gemma2_global_cap50": ((1, 1000, 1000, 4, 2, 128), True, None, 50.0),
    "llama_gqa4_hd64": ((2, 777, 777, 8, 2, 64), True, None, None),
    "gqa4_hd128": ((1, 777, 777, 8, 2, 128), True, None, None),
    "mha_hd128": ((1, 500, 500, 4, 4, 128), True, None, None),
    "cross_unmasked": ((1, 300, 77, 4, 2, 64), False, None, None),
    "hd96_window": ((1, 200, 200, 4, 1, 96), True, 64, None),
    "hd33_element_copies": ((1, 130, 130, 4, 2, 33), True, 50, None),
    "no_key_rows_window": ((1, 100, 77, 4, 2, 16), False, 20, None),
    "no_key_rows_causal": ((1, 400, 150, 2, 1, 16), True, 20, None),
}


def k5_options_phase(torch, dev):
    """Phase 8, continued: K5 against its plain version in f32 and bf16
    on ``K5_OPTIONS``, inputs from a seed; bf16 also in RMS units of the
    f32 plain output of the same bf16 inputs.  A planted fault per case
    (the cap dropped, the window one wider, or causal off) must read over
    the f32 limit and, through the bf16 kernel, over the bf16 RMS limit,
    so each case shows that its options are applied in both dtypes."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    got = {}
    for name, ((B_, S, T, H, K_, hd), causal, window, cap) in \
            K5_OPTIONS.items():
        def randn(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        # scores of std 60 when capped, so that the cap bites
        q = randn(B_, S, H, hd) * (60.0 if cap else 1.0) * hd ** -0.5
        k, v = randn(B_, T, K_, hd), randn(B_, T, K_, hd)
        kw = {"causal": causal, "window": window, "cap": cap}
        plain = attention_ref(q, k, v, **kw)
        r = {"f32_rms_units": rms_err(fk.flash_attention(q, k, v, **kw),
                                      plain)}
        q16, k16, v16 = q.bfloat16(), k.bfloat16(), v.bfloat16()
        out16 = fk.flash_attention(q16, k16, v16, **kw)
        r["bf16_rel"] = rel_err(out16, attention_ref(q16, k16, v16, **kw))
        plain16 = attention_ref(q16.float(), k16.float(), v16.float(), **kw)
        r["bf16_rms_units"] = rms_err(out16, plain16)
        wrong = (dict(kw, cap=None) if cap else
                 dict(kw, window=window + 1) if window else
                 dict(kw, causal=not causal))
        r["fault"] = rms_err(fk.flash_attention(q, k, v, **wrong), plain)
        r["bf16_fault"] = rms_err(fk.flash_attention(q16, k16, v16, **wrong),
                                  plain16)
        got[name] = r
    torch.cuda.synchronize()
    emit({"phase": "K5_options", "limits": {"f32": K5_F32_LIMIT,
                                            "bf16": BF16_LIMIT,
                                            "bf16_rms": K5_BF16_RMS_LIMIT},
          "readings": got})
    for name, r in got.items():
        check(r["f32_rms_units"] <= K5_F32_LIMIT,
              f"K5 {name} vs plain in f32: {r['f32_rms_units']:.3e}")
        check(r["bf16_rel"] <= BF16_LIMIT,
              f"K5 {name} vs plain in bf16: {r['bf16_rel']:.3e}")
        check(r["fault"] > K5_F32_LIMIT,
              f"K5 {name}: the planted fault reads {r['fault']:.3e}")
        check(r["bf16_rms_units"] <= K5_BF16_RMS_LIMIT,
              f"K5 {name} bf16 vs f32 plain: {r['bf16_rms_units']:.3e}")
        check(r["bf16_fault"] > K5_BF16_RMS_LIMIT,
              f"K5 {name}: the planted fault in bf16 reads "
              f"{r['bf16_fault']:.3e}")


# K4's shapes that test its chunks and lanes: (B, S, D).  One step; under
# one chunk; S not a multiple of the chunk; B·D not a multiple of the
# block's lanes; a long S, where the look-back chain is longest; and the
# serving shape (where bf16 is read as on every shape).  a in (0.8, 1),
# as RG-LRU's gates are, and b of std 0.1, from a seed.
K4_OPTIONS = {
    "one_step": (2, 1, 2560),
    "under_one_chunk": (2, 40, 2560),
    "ragged_chunks": (3, 1000, 2560),
    "ragged_lanes": (1, 777, 96),
    "long_chain": (1, 65536, 64),
    "serving": (2, 4096, 2560),
}


def k4_options_phase(torch, dev):
    """Phase 8, continued: K4 against its plain version on
    ``K4_OPTIONS``: f32 in RMS units, bf16 relative, and where S spans at
    least two chunks the planted faults over the f32 limit."""
    from repro_torch.kernels.linear_scan import kernel as sk
    from repro_torch.kernels.linear_scan.ref import linear_scan_ref

    gen = torch.Generator(device=dev).manual_seed(0)
    got = {}
    for name, shape in K4_OPTIONS.items():
        a = 0.8 + 0.2 * torch.rand(shape, generator=gen, device=dev)
        b = 0.1 * torch.randn(shape, generator=gen, device=dev)
        plain = linear_scan_ref(a, b)
        r = {"f32_rms_units": rms_err(sk.linear_scan(a, b), plain)}
        a16, b16 = a.bfloat16(), b.bfloat16()
        r["bf16_rel"] = rel_err(sk.linear_scan(a16, b16),
                                linear_scan_ref(a16, b16))
        if shape[1] > sk.CHUNK:
            for fault in ("carry_reset_halfway", "step_one_slot_late"):
                r[f"fault_{fault}"] = rms_err(SCAN_FAULTS[fault](a, b),
                                              plain)
        got[name] = r
    torch.cuda.synchronize()
    emit({"phase": "K4_options", "chunk": sk.CHUNK, "lanes": sk.LANES,
          "limits": {"f32": K4_F32_LIMIT, "bf16": BF16_LIMIT},
          "readings": got})
    for name, r in got.items():
        check(r["f32_rms_units"] <= K4_F32_LIMIT,
              f"K4 {name} vs plain in f32: {r['f32_rms_units']:.3e}")
        check(r["bf16_rel"] <= BF16_LIMIT,
              f"K4 {name} vs plain in bf16: {r['bf16_rel']:.3e}")
        for key, val in r.items():
            if key.startswith("fault_"):
                check(val > K4_F32_LIMIT, f"K4 {name}: the planted fault "
                                          f"{key} reads {val:.3e}")


def route_replay(torch, routes):
    """A stand-in for ``models.moe._router`` that takes each call's top-k
    from ``routes`` (another run's, call for call) and its weights from
    this run's own router probabilities there, renormalised."""
    from repro_torch.models import moe as moe_mod
    router = moe_mod._router
    it = iter(routes)

    def run(m, x, cfg):
        _, top_i, aux = router(m, x, cfg)
        top_i = next(it).to(device=x.device, dtype=torch.long)
        check(top_i.shape == (x.shape[0], cfg.top_k),
              f"replayed routes {tuple(top_i.shape)} for {x.shape[0]} rows")
        probs = torch.softmax(x.float() @ m.router.float(), dim=-1)
        top_p = probs.gather(1, top_i)
        return top_p / torch.clamp_min(top_p.sum(-1, keepdim=True), 1e-9), \
            top_i, aux
    return mock.patch.object(moe_mod, "_router", run)


def teacher_forced(torch, model, batch, tokens, routes=None, replay=None):
    """Logits of the prefill over ``batch`` and of decode steps fed
    ``tokens`` (B, n) one at a time.  With ``routes`` (a list), each MoE
    router call appends its top-k to it; with ``replay``, each takes its
    top-k from there (``route_replay``)."""
    from repro_torch.models import decode_step, prefill
    with contextlib.ExitStack() as stack:
        if replay is not None:
            stack.enter_context(route_replay(torch, replay))
        elif routes is not None:
            stack.enter_context(route_recorder(torch, routes, lambda: True))
        with torch.inference_mode():
            logits, state = prefill(model, batch, max_len=cache_len(batch))
            out = [logits]
            for t in range(tokens.shape[1]):
                logits, state = decode_step(model, tokens[:, t:t + 1],
                                            state)
                out.append(logits)
    return out


def kernel_sites(arch):
    """The model's kernel call sites for ``arch``: kernel → (module,
    attribute, plain version)."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.linear_scan.ref import linear_scan_ref
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import rglru as rglru_mod
    from repro_torch.models import scan_ops
    if arch == MAMBA_ARCH:
        return {"K4": (scan_ops, "linear_scan_op", linear_scan_ref)}
    return {"K5": (attn_mod, "flash_attention_op", attention_ref),
            "K4": (rglru_mod, "linear_scan_op", linear_scan_ref)}


E2E_FAULTS = {"bf16": ["K4_no_carry"],
              "f32": ["K4_carry_reset_halfway", "K4_step_one_slot_late",
                      "K5_window_plus_1", "K5_dropped_last_kv_tile",
                      "K5_causal_off"]}
# Phase 17's archs attend globally (no window).  Their planted faults are
# held in f32; in bf16 they are read and printed, not held: with random
# weights the attention branch moves the bf16 logits by little more than
# one bf16 ulp of the largest logit (phase 9's finding), and on
# qwen2-moe-a2.7b at fixed routes causal off read 0.344 std against the
# sound kernel's 0.211 and the limit 0.5.
E2E_ATTN_FAULTS = {"bf16": [],
                   "f32": ["K5_dropped_last_kv_tile", "K5_causal_off"]}
E2E_ATTN_BF16_READ = ["K5_dropped_last_kv_tile", "K5_causal_off"]


def linear_scan_f64(a, b, block=16):
    """The plain scan with its state in float64, rounded to a's dtype at
    the end: a plain version more exact than ``linear_scan_ref``, whose
    distance from it is the end-to-end floor of a deep model.  Blocks of
    ``block`` steps are scanned side by side from a zero state with their
    running products of a, then the carry goes from block to block (in
    float64 the order of the sums moves nothing at f32's scale)."""
    import torch
    B_, S, D = a.shape
    n = -(-S // block)
    A = torch.ones(B_, n * block, D, dtype=torch.float64, device=a.device)
    Bv = torch.zeros_like(A)
    A[:, :S], Bv[:, :S] = a, b
    A, Bv = A.view(B_, n, block, D), Bv.view(B_, n, block, D)
    hs, ps = torch.empty_like(A), torch.empty_like(A)
    h, p = torch.zeros_like(A[:, :, 0]), torch.ones_like(A[:, :, 0])
    for t in range(block):
        h = A[:, :, t] * h + Bv[:, :, t]
        p = p * A[:, :, t]
        hs[:, :, t], ps[:, :, t] = h, p
    carry = torch.zeros_like(A[:, 0, 0])
    for k in range(n):
        hs[:, k] += ps[:, k] * carry[:, None]
        carry = hs[:, k, -1]
    return hs.view(B_, n * block, D)[:, :S].to(a.dtype)


def route_diff(torch, cfg, routes, ref):
    """Top-k selections and capacity decisions that differ between two
    runs' router calls (lists of (N, k) top-k, call for call): entries of
    top-k that differ (an order swap among the k counts), and slots kept
    in one run and dropped in the other (``moe.slot_positions`` over the
    call's groups of min(group size, N))."""
    from repro_torch.models.moe import capacity, slot_positions
    check(len(routes) == len(ref), f"router calls {len(routes)} vs "
                                   f"{len(ref)}")
    sel = drops = 0
    for a, b in zip(routes, ref):
        sel += int((a != b).sum())
        N, k = a.shape
        G = min(cfg.moe_group_size, N)
        C = capacity(cfg, G)
        keep = [slot_positions(t.long().view(-1, G, k),
                               cfg.n_experts)[1] < C for t in (a, b)]
        drops += int((keep[0] != keep[1]).sum())
    return {"selections": sel, "drops": drops, "calls": len(routes)}


def perturbed_attention(torch, rel, seed):
    """The plain attention with f32 noise of ``rel`` times its output's
    RMS added (from a generator seeded ``seed``), rounded to the output's
    dtype: a plain run as far from the plain run as K5 reads."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    gens = {}

    def run(q, k, v, causal=True, window=None, cap=None):
        out = attention_ref(q, k, v, causal=causal, window=window, cap=cap)
        if q.device not in gens:
            gens[q.device] = torch.Generator(q.device).manual_seed(seed)
        o = out.float()
        noise = torch.randn(o.shape, generator=gens[q.device],
                            device=q.device)
        return (o + noise * (rel * o.pow(2).mean().sqrt())).to(out.dtype)
    return run


def f32_copy(torch, model, n_layers=None):
    """An f32 copy of ``model``, or of its first ``n_layers`` layers (the
    embeddings, norms and any encoder as they are)."""
    import copy
    from repro_torch.models.transformer import Transformer
    if n_layers is None or n_layers >= len(model.layers):
        return copy.deepcopy(model).float()
    cfg = model.cfg.replace(n_layers=n_layers)
    m = Transformer(cfg, device="meta", dtype=torch.float32).to_empty(
        device=model.device)
    keep = m.state_dict()
    m.load_state_dict({k: v for k, v in model.state_dict().items()
                       if k in keep})
    return m


def end_to_end_phase(torch, model, batch, out, cap, arch=ARCH,
                     prefix="serve", floor=False, perturb=None,
                     f32_layers=None):
    """Phase 9 (and 16(b), 17): wave 0 through the plain versions,
    teacher-forced on the kernel run's tokens, logits in units of the
    plain run's std: the bf16 path itself, then the same weights in f32
    (or, with ``f32_layers``, its first layers in f32); planted faults of
    the model's kernels (``E2E_FAULTS``, ``E2E_ATTN_FAULTS``) must read
    over the limits (phase 17's bf16 faults, ``E2E_ATTN_BF16_READ``, are
    printed as ``faults_read`` and not held).

    A floor is what rounding alone moves the logits by, measured as the
    plain run's distance from another plain version: with ``floor``, K4's
    state in float64 (``linear_scan_f64``); with ``perturb`` ({dtype:
    relative RMS}), the plain attention with noise of K5's reading's size
    (``perturbed_attention``, two seeds).  The limit is then the larger
    of phase 9's and twice the floor (a kernel as exact as the plain
    version reads at most its own and the plain version's distance).

    A MoE's routes are discrete, and a near tie moved by a rounding moves
    a token's experts, its capacity slot, and through attention every
    later token.  So its runs are compared twice: each run routing
    freely, the top-k selections and capacity drops that differ from the
    plain run's (``route_diff``) at most twice the floor runs' largest
    count; and the logits, every run (plain, floors, faults) replaying
    the kernel run's routes (``route_replay``), so that they read what
    the kernel moves at fixed routes.  Prints ``<prefix>_end_to_end``."""
    from repro_torch.models.moe import MoE

    sites = kernel_sites(arch)
    fed = torch.as_tensor(out[:, :-1], device=model.device)
    moe = any(isinstance(b.mlp, MoE) for b in model.layers)
    faults_of = (E2E_FAULTS if arch in (ARCH, MAMBA_ARCH)
                 else E2E_ATTN_FAULTS)

    def plain_run(m, plain_fns=None, routes=None, replay=None):
        """The model's kernel call sites swapped for the plain versions
        (or for ``plain_fns[kernel]``), as ``faults`` swaps them for
        planted faults."""
        with contextlib.ExitStack() as stack:
            for kernel, (mod, attr, plain_fn) in sites.items():
                fn = (plain_fns or {}).get(kernel, plain_fn)
                stack.enter_context(mock.patch.object(mod, attr, fn))
            return teacher_forced(torch, m, batch, fed, routes, replay)

    def per_step(logits, plain):
        return [float((x.float() - y.float()).abs().max() / y.float().std())
                for x, y in zip(logits, plain)]

    def faults(m, plain, replay, names):
        got = {}
        for name in names:
            kernel, fault = name.split("_", 1)
            if kernel not in sites:
                continue
            mod, attr, _ = sites[kernel]
            wrong = (SCAN_FAULTS if kernel == "K4" else ATTN_FAULTS)[fault]
            with mock.patch.object(mod, attr, wrong):
                got[name] = max(per_step(teacher_forced(
                    torch, m, batch, fed, replay=replay), plain))
        return got

    def floor_fns(dtype):
        if floor:
            return [{"K4": linear_scan_f64}]
        if perturb:
            return [{"K5": perturbed_attention(torch, perturb[dtype], seed)}
                    for seed in (1, 2)]
        return []

    def check_run(r, m, dtype, plain, limit, kernel_routes):
        """The floor and limit of ``r``; for a MoE the free-running route
        comparison."""
        floors = [max(per_step(plain_run(m, fns, replay=kernel_routes),
                               plain)) for fns in floor_fns(dtype)]
        if floors:
            r["floor"] = max(floors)
            r["floors"] = floors
        r["limit"] = max(limit, 2.0 * r.get("floor", 0.0))
        if moe:
            free = []
            plain_run(m, routes=free)
            r["routes"] = route_diff(torch, m.cfg, kernel_routes, free)
            r["route_floors"] = []
            for fns in floor_fns(dtype):
                rts = []
                plain_run(m, fns, routes=rts)
                r["route_floors"].append(route_diff(torch, m.cfg, rts, free))
            r["route_limits"] = {
                key: 2 * max([f[key] for f in r["route_floors"]] or [0])
                for key in ("selections", "drops")}
        return r

    t0 = time.perf_counter()
    routes16 = cap["routes"] if moe else None
    plain = plain_run(model, replay=routes16)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    steps = per_step(cap["logits"], plain)
    tokens_equal = bool((torch.stack([x.argmax(-1) for x in plain], 1)
                         .cpu().numpy() == out).all())
    attn_only = faults_of is E2E_ATTN_FAULTS
    r16 = check_run({"sound": max(steps), "per_step": steps,
                     "faults": faults(model, plain, routes16,
                                      faults_of["bf16"]),
                     "greedy_tokens_equal": tokens_equal,
                     "plain_run_s": plain_s}, model, "bf16", plain,
                    E2E_BF16_LIMIT, routes16)
    if attn_only:
        r16["faults_read"] = faults(model, plain, routes16,
                                    E2E_ATTN_BF16_READ)
    del plain

    m32 = f32_copy(torch, model, f32_layers)
    routes32 = [] if moe else None
    logits32 = teacher_forced(torch, m32, batch, fed, routes32)
    plain = plain_run(m32, replay=routes32)
    steps = per_step(logits32, plain)
    r32 = check_run({"sound": max(steps), "per_step": steps,
                     "layers": len(m32.layers),
                     "faults": faults(m32, plain, routes32,
                                      faults_of["f32"])}, m32,
                    "f32", plain, E2E_F32_LIMIT, routes32)
    del m32, plain, logits32, routes32
    emit({"phase": f"{prefix}_end_to_end",
          "limits": {"bf16": E2E_BF16_LIMIT, "f32": E2E_F32_LIMIT},
          "routes_replayed": moe, "bf16": r16, "f32": r32})
    for name, r in (("bf16", r16), ("f32", r32)):
        lim = r["limit"]
        check(r["sound"] <= lim, f"{arch} end to end in {name}, kernels vs "
                                 f"plain: {r['sound']:.3e} > {lim}")
        check(r["faults"] or (attn_only and name == "bf16"),
              f"{arch} end to end in {name}: no planted fault")
        for fault, val in r["faults"].items():
            check(val > lim, f"{arch} end to end in {name}: the planted "
                             f"fault {fault} reads {val:.3e}, within {lim}")
        for key, lim_r in r.get("route_limits", {}).items():
            check(r["routes"][key] <= lim_r,
                  f"{arch} in {name}: {r['routes'][key]} {key} differ from "
                  f"the plain run's, over twice the floor's ({lim_r})")


def serve_profile(torch, model, batch):
    """Where a wave's time goes on the device: the prefill alone, then a
    whole ``generate`` (prefill and 15 decode steps), each traced once
    after an untraced warm-up; busy share = device kernel time / wall."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import ServeEngine

    eng = ServeEngine(model=model, max_len=cache_len(batch))
    got = {}
    for part, run in (("prefill", lambda: eng._prefill(batch)),
                      ("generate", lambda: eng.generate(batch, GEN))):
        with torch.inference_mode():
            run()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        on_dev = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.device_time_total for e in on_dev) / 1e6
        check(busy > 0, f"the profile of a wave's {part} saw no device work")
        top = sorted(on_dev, key=lambda e: -e.device_time_total)[:6]
        got[part] = {"wall_s": wall, "device_busy_s": busy,
                     "busy_share": busy / wall,
                     "device_kernels": sum(e.count for e in on_dev),
                     "top": [[e.key[:80], e.device_time_total / 1e3, e.count]
                             for e in top]}
    got["decode_only"] = {
        k: got["generate"][k] - got["prefill"][k]
        for k in ("wall_s", "device_busy_s", "device_kernels")}
    got["decode_only"]["busy_share"] = (got["decode_only"]["device_busy_s"]
                                        / got["decode_only"]["wall_s"])
    emit({"phase": "serve_profile", **got})


def kernel_record(torch, name, src, tpu, op, plain_runs, bound_, lib_ms,
                  launches, err, phase="time"):
    """One kernel's line of the summary: op ms (``op("cuda")``), plain ms
    (``op("ref")``), the kernel's device ms from a profiler trace, the
    bound, the library call's ms.  Prints it as a ``phase`` line."""
    ms_k = timed(torch, lambda: op("cuda"))
    ms_p = timed(torch, lambda: op("ref"), runs=plain_runs)
    mine, _ = traced_kernel(torch, lambda: op("cuda"), f"{name}_kernel")
    n = len(mine)
    check(n > 0, f"the profiler saw no {name} kernel on the device")
    b_ms, by = bound_
    rec = {"name": name, "route": "cuda", "source": src, "replaces": tpu,
           "launches": launches, "max_abs_err": err, "ms": ms_k,
           "plain_ms": ms_p, "bound_ms": b_ms, "bound_by": by,
           "library_ms": lib_ms, "kernel_device_ms": sum(mine) / 1e6 / n}
    emit({"phase": phase, **rec, "traced_launches": n})
    return rec


def scan_bound(a):
    """K4's bound on (B, S, D) inputs: a and b read, h written; two f32
    operations a step and channel."""
    return bound(a.element_size() * 3 * a.numel(), 2 * a.numel())


def serve_times(torch, cap, launches, errs):
    """Phase 10: K5 and K4 at the path's shapes: kernel and plain ms,
    the kernel's device ms, the bound, K5's library yardstick."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fo
    from repro_torch.kernels.linear_scan import ops as so

    (q, k, v), kw = cap["qkv"][0]
    kw = {n: kw[n] for n in ("causal", "window", "cap")}
    a, b = cap["ab"][0][0][:2]
    B_, S, H, hd = q.shape
    W = kw["window"]
    # valid (q, k) pairs of one (b, h) row block: min(i + 1, W) keys for
    # query i; QKᵀ and PV cost 2·hd operations each per pair
    pairs = sum(min(i + 1, W) for i in range(S))
    k5_ops = 4 * B_ * H * hd * pairs
    k5_bytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    pos = torch.arange(S, device=q.device)
    mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :] < W)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              scale=1.0, enable_gqa=True)

    lib_err = rel_err(sdpa().transpose(1, 2),
                      fo.attention_ref(q, k, v, **kw))
    recs = [
        kernel_record(torch, "flash_attention", CU_K5, TPU_K5,
                      lambda impl: fo.flash_attention_op(q, k, v, impl=impl,
                                                         **kw),
                      5, bound(k5_bytes, k5_ops, BF16_TC_OPS),
                      timed(torch, sdpa), launches["flash_attention"],
                      errs["flash_attention"]),
        kernel_record(torch, "linear_scan", CU_K4, TPU_K4,
                      lambda impl: so.linear_scan_op(a, b, impl=impl),
                      3, scan_bound(a), None, launches["linear_scan"],
                      errs["linear_scan"])]
    q32, k32, v32 = q.float(), k.float(), v.float()
    emit({"phase": "K5_f32_time", "q": list(q.shape), **kw,
          "ms": timed(torch, lambda: fo.flash_attention_op(
              q32, k32, v32, impl="cuda", **kw), runs=5)})
    emit({"phase": "library", "flash_attention_sdpa_ms": recs[0]["library_ms"],
          "sdpa_vs_plain_bf16_rel": lib_err,
          "linear_scan": "no single PyTorch call computes a linear "
                         "recurrence scan; library_ms is null"})
    return recs


# Phase 11: per-job SmartFill (paper §7) in float64 on the card.  The
# fleet is the sampler's mixed five-family per-job batch at N = 256, M =
# 32 (2..32 live jobs); the exchange search runs on eight mixed members
# (ten until phase 19 needed the room) with slowdown weights under each
# job's own curve, w_i = s_i(B)/x_i (the shape of
# examples/hetero_fleet.py).  SmartFill's inner CAP is the float64 sorted
# solver: no K1–K5 launch may happen in the phase.  The fleet's
# heuristic orders are realized (J == J_linear) on 62 of its 256
# instances; on the others J is a schedule quantity (see the check).
# Phase 14 certifies its largest plan, which must be sound: at N = 128
# the largest instance's order is not realized and its KKT rows read
# 0.031 (the CPU rehearsal), so the fleet stays at 256.
HETERO_N, HETERO_M, HETERO_SEED = 256, 32, 0
EXCHANGE_M, EXCHANGE_SEED = 8, 1


def all_launches():
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.gwf_waterfill import kernel as wk
    from repro_torch.kernels.linear_scan import kernel as sk
    return {**wk.LAUNCHES, **fk.LAUNCHES, **sk.LAUNCHES}


def reset_all_launches():
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.gwf_waterfill import kernel as wk
    from repro_torch.kernels.linear_scan import kernel as sk
    for mod in (wk, fk, sk):
        mod.reset_launches()


def exchange_instance(torch, np, dev):
    """Ten mixed per-job members, sizes U(2, 15), w_i = s_i(B)/x_i."""
    from repro_torch.core import sample_workloads
    from repro_torch.core.speedup import map_leaves
    wl = sample_workloads(EXCHANGE_SEED, K=1, M=EXCHANGE_M, B=B,
                          family=("power", "shifted", "log", "neg_power",
                                  "saturating"), per_job=True, device=dev)
    sp = map_leaves(wl.sp, lambda l: l[0])
    x = np.random.default_rng(EXCHANGE_SEED).uniform(2.0, 15.0, EXCHANGE_M)
    rate = sp.s(torch.full((EXCHANGE_M,), B, dtype=torch.float64,
                           device=sp.A.device)).cpu().numpy()
    return sp, x, rate / x


def device_profile(torch, run):
    """(wall s, device busy s, device records, kernel launches) of one
    ``run()`` traced by the profiler's CUDA activity alone.  The device
    events are summed straight from the trace: building the profiler's
    per-op tables for a call of ~10⁶ kernels takes minutes.  The host's
    launch records are all kept, the device's not always (see
    ``traced_kernel``), so busy time is a lower bound where the two
    counts differ."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    t_all = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        wall = time.perf_counter() - t0
    t1 = time.perf_counter()
    events = prof.profiler.kineto_results.events()
    on_dev = [e for e in events if e.device_type() == DeviceType.CUDA]
    busy = sum(e.duration_ns() for e in on_dev) / 1e9
    n_launch = sum(e.device_type() == DeviceType.CPU
                   and "LaunchKernel" in e.name() for e in events)
    emit({"phase": "profile_cost", "trace_stop_s": t1 - t0 - wall,
          "events": len(events), "read_s": time.perf_counter() - t1,
          "total_s": time.perf_counter() - t_all})
    return wall, busy, len(on_dev), n_launch


def hetero_phase(torch, np, dev):
    """Phase 11: the per-job planning path on ``dev``, held against the
    same calls on the CPU.  Returns the launch counts of the phase, all
    of which must be 0, and the fleet's (workloads, orders, schedule)
    for phase 14's certificates."""
    from repro_torch.core import (FAMILIES, sample_workloads,
                                  smartfill_hetero, smartfill_hetero_batched,
                                  smartfill_warm)
    from repro_torch.core.speedup import map_leaves

    cpu = torch.device("cpu")
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    reset_all_launches()
    kw = dict(family=FAMILIES, per_job=True, m_range=(2, HETERO_M), B=B)
    wl = sample_workloads(HETERO_SEED, K=HETERO_N, M=HETERO_M, device=dev,
                          **kw)
    wl_cpu = sample_workloads(HETERO_SEED, K=HETERO_N, M=HETERO_M,
                              device=cpu, **kw)

    def fleet_on(w):
        return smartfill_hetero_batched(w.sp, w.X, w.W, B=B, active=w.active)

    t0 = time.perf_counter()
    orders, sched = fleet_on(wl)
    sync()
    t1 = time.perf_counter()
    orders_c, sched_c = fleet_on(wl_cpu)
    fleet = {"N": HETERO_N, "M": HETERO_M, "families": list(FAMILIES),
             "live_jobs": [2, HETERO_M], "wall_s": t1 - t0,
             "host_cpu_wall_s": time.perf_counter() - t1}
    check(sched.J.device.type == dev.type and sched.J.dtype == torch.float64,
          "the fleet ran off the device or out of float64")
    check(np.array_equal(orders, orders_c),
          "fleet: the card's orders differ from the CPU run's")
    Jg, Jc = sched.J.cpu(), sched_c.J
    Jlin, Jlin_c = sched.J_linear.cpu(), sched_c.J_linear
    check(bool(torch.isfinite(Jg).all()), "fleet J not finite")
    # J is the value function (Prop. 9) only where the order is realized
    # (J == J_linear); elsewhere it is the executed cost of clamped
    # durations, linear in where the μ-descent stops, which rounding
    # moves: a schedule quantity, held to T's tolerance
    realized = ((Jc - Jlin_c).abs() / Jc) <= 1e-9
    rel = (Jg - Jc).abs() / Jc
    n0 = int(np.argmax(wl.m))
    m0 = int(wl.m[n0])
    # the single-instance planner as the yardstick, on the host: one
    # instance costs the card as many launches as the whole fleet
    single = smartfill_hetero(
        map_leaves(wl_cpu.sp, lambda l: l[n0, :m0]), wl.X[n0, :m0],
        wl.W[n0, :m0], B=B, exchange_passes=0)
    fleet.update(
        card_vs_cpu_realized=float(torch.where(realized, rel, 0.0).max()),
        card_vs_cpu_unrealized=float(torch.where(realized, 0.0, rel).max()),
        J_linear_card_vs_cpu=float(((Jlin - Jlin_c).abs() / Jlin_c).max()),
        rows_over_1e_9=int((rel > 1e-9).sum()), realized=int(realized.sum()),
        J_below_J_linear=float((Jlin * (1 - 1e-9) - Jg).clamp_min(0).max()),
        largest_vs_single=abs(float(Jg[n0]) - single.J) / single.J)
    emit({"phase": "hetero_fleet", **fleet})
    check(fleet["card_vs_cpu_realized"] <= 1e-9
          and fleet["J_linear_card_vs_cpu"] <= 1e-9
          and fleet["card_vs_cpu_unrealized"] <= 1e-6,
          f"fleet card vs CPU beyond 1e-9 (J on realized orders, J_linear) "
          f"or 1e-6 (J on the others): {fleet}")
    check(fleet["J_below_J_linear"] == 0.0,
          "fleet: J below J_linear·(1 − 1e-9)")
    check(fleet["largest_vs_single"] <= 1e-6,
          f"fleet: largest instance vs single {fleet['largest_vs_single']}")

    # the exchange search, window 1 and 2, card against the CPU (the
    # heuristic order's plan, the yardstick, from the CPU)
    sp, x, w = exchange_instance(torch, np, dev)
    sp_c, _, _ = exchange_instance(torch, np, cpu)
    heur = smartfill_hetero(sp_c, x, w, B=B, exchange_passes=0)
    for window in (1, 2):
        t0 = time.perf_counter()
        plan = smartfill_hetero(sp, x, w, B=B, exchange_passes=2,
                                exchange_window=window)
        sync()
        wall = time.perf_counter() - t0
        plan_c = smartfill_hetero(sp_c, x, w, B=B, exchange_passes=2,
                                  exchange_window=window)
        r = {"M": EXCHANGE_M, "wall_s": wall, "J": plan.J,
             "J_linear": plan.J_linear, "heuristic_J": heur.J,
             "order": plan.order.tolist(),
             "heuristic_order": heur.order.tolist(),
             "J_vs_J_linear": abs(plan.J - plan.J_linear) / plan.J,
             "card_vs_cpu": abs(plan.J - plan_c.J) / plan_c.J}
        emit({"phase": f"hetero_exchange_window_{window}", **r})
        check(r["J_vs_J_linear"] <= 1e-6,
              f"exchange window {window}: J vs J_linear {r}")
        check(plan.J <= heur.J * (1 + 1e-12),
              f"exchange window {window}: J above the heuristic order's")
        check(np.array_equal(plan.order, plan_c.order)
              and r["card_vs_cpu"] <= 1e-9,
              f"exchange window {window}: card vs CPU {r}")

    # warm re-planning in the searched order: a cold call, then a call
    # seeded with its payload
    p = torch.as_tensor(plan.order)
    sp_o = map_leaves(sp, lambda l: l[p.to(l.device)])
    x_o, w_o = x[plan.order], w[plan.order]
    t0 = time.perf_counter()
    cold, payload = smartfill_warm(sp_o, x_o, w_o, B=B)
    sync()
    t1 = time.perf_counter()
    warm, _ = smartfill_warm(sp_o, x_o, w_o, B=B, warm=payload)
    sync()
    r = {"cold_wall_s": t1 - t0, "warm_wall_s": time.perf_counter() - t1,
         "warm_vs_cold": abs(warm.J - cold.J) / cold.J}
    emit({"phase": "hetero_warm", **r})
    check(r["warm_vs_cold"] <= 1e-9, f"warm vs cold J {r}")
    launches = all_launches()
    check(not any(launches.values()),
          f"a kernel was launched in the per-job phase: {launches}")
    return launches, (wl, orders, sched)


# ---- 12. the scenario engine ------------------------------------------------
# Every run of phase 12 goes through simulate_ensemble on the card and is
# held against the port's own run of the same call on the CPU: J and T
# to the reference's RTOL (tests/core/test_simulator.py) and the same
# n_events for every (policy, workload).  (a) is examples/policy_faceoff.py
# at its own size (K = 128, M = 8, ln(1+θ)); (b) the five-policy zoo at
# fleet size under the shared s = √θ, plain, with arrivals and with the
# fault mix of the reference's robust_faulted_ensemble row; (c) the §7
# path (pinned heteroSF with its cached plan, and WMR) on a per-job
# five-family fleet, then a budget step that must invalidate the cached
# table; (d) GWF-static and WMR in float32, where impl="auto" sends their
# CAP to K1 and K2 at every event, held to the float64 runs with a limit
# set between the sound reading and a planted fault: the same run with
# the kernels' bisection cut to FAULT_ITERS steps.
ENGINE_RTOL = 1e-6
FACEOFF_K, FACEOFF_M, FACEOFF_SEED = 128, 8, 0
FLEET_K, FLEET_M, FLEET_SEED, FLEET_FAULT_SEED = 1024, 32, 21, 22
# the CPU's run of (b) takes the first FLEET_CPU_K workloads (the whole
# fleet's took ~40 s of the card machine's host; workloads are
# independent, so the card's first rows must give the same numbers)
FLEET_CPU_K = 256
# (c)'s per-job fleet: 128 workloads (256 until phase 19 needed the room)
HSIM_K, HSIM_M, HSIM_SEED = 128, 16, 8
MOVE_LANES = 8            # workloads of (c) that see the budget step
F32_LIMIT = {"K1": 1e-4, "K2": 1e-4}   # max |J32 − J64| / J64
FAULT_ITERS = 8


def ensemble_vs_cpu(torch, res, res_c):
    """Card against CPU: largest relative ΔJ and ΔT (in units of
    1 + |T|, the reference's atol = rtol), and whether n_events,
    finished and exhausted agree exactly.  The CPU run may hold the
    first workloads only."""
    k = res_c.J.shape[1]
    Jg, Tg = res.J[:, :k].cpu(), res.T[:, :k].cpu()
    return {"J_rel": float(((Jg - res_c.J).abs() / res_c.J).max()),
            "T": float(((Tg - res_c.T).abs() / (1 + res_c.T.abs())).max()),
            "n_events_equal": bool(torch.equal(res.n_events[:, :k].cpu(),
                                               res_c.n_events)),
            "finished_equal": bool(torch.equal(res.finished[:, :k].cpu(),
                                               res_c.finished)),
            "all_finished": bool(res.finished.all()),
            "none_exhausted": not bool(res.exhausted.any())}


def check_vs_cpu(tag, r):
    check(r["J_rel"] <= ENGINE_RTOL and r["T"] <= ENGINE_RTOL
          and r["n_events_equal"] and r["finished_equal"]
          and r["all_finished"] and r["none_exhausted"],
          f"{tag}: card vs CPU {r}")


def faceoff_table(np, J, names):
    """examples/policy_faceoff.py's table: mean and median J, mean gap to
    SmartFill (row 0) and the share of workloads that tie it."""
    lines = [f"{'policy':<12} {'mean J':>10} {'median J':>10} "
             f"{'gap vs SF':>10} {'ties SF':>8}"]
    gaps = {}
    for i, name in enumerate(names):
        gap = 100.0 * (J[i] - J[0]) / J[0]
        ties = np.mean(J[i] <= J[0] * (1 + 1e-9))
        gaps[name] = float(gap.mean())
        lines.append(f"{name:<12} {J[i].mean():>10.4f} "
                     f"{np.median(J[i]):>10.4f} {gap.mean():>9.2f}% "
                     f"{100 * ties:>7.0f}%")
    return lines, gaps


def engine_phase(torch, np, dev):
    """Phase 12: the scenario engine on ``dev`` against the same calls on
    the CPU (on a CPU ``dev``, a rehearsal: no profile, and step d's
    float32 CAP runs the kernels' plain versions).  Returns the K1 and K2
    launches of step d."""
    import dataclasses

    from repro_torch.core import (FAMILIES, FaultTrace, budget_trace,
                                  fit_power, log_speedup, power,
                                  sample_fault_traces,
                                  sample_workloads, shifted_power,
                                  simulate_ensemble,
                                  simulate_policy_reference,
                                  smartfill_hetero_batched)
    from repro_torch.core import gwf
    from repro_torch.core.speedup import map_leaves
    from repro_torch.kernels.gwf_waterfill import kernel as wk
    from repro_torch.sched import (GWFStaticPolicy, HeteroSmartFillPolicy,
                                   WeightedMarginalRatePolicy, default_zoo)
    from repro_torch.sched import policies as pol_mod

    cpu = torch.device("cpu")
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def timed_run(run):
        t0 = time.perf_counter()
        out = run()
        sync()
        return out, time.perf_counter() - t0

    def rates(res, wall):
        ev = int(res.n_events.sum())
        P, K = res.J.shape
        return {"wall_s": wall, "events": ev, "events_per_s": ev / wall,
                "instances_per_s": P * K / wall,
                "steps": int(res.n_events.max())}

    # ---- a. examples/policy_faceoff.py at its own size --------------------
    a_fit, p_fit = fit_power(lambda t: np.log1p(t), B)
    wl = sample_workloads(seed=FACEOFF_SEED, K=FACEOFF_K, M=FACEOFF_M, B=B,
                          m_range=(3, FACEOFF_M))

    def faceoff(d):
        sp = log_speedup(1.0, 1.0, B, device=d)
        return simulate_ensemble(sp, default_zoo(sp, p_fit=p_fit), wl.X,
                                 wl.W, B=B, device=d)

    res, wall = timed_run(lambda: faceoff(dev))
    t0 = time.perf_counter()
    res_c = faceoff(cpu)
    r = {"K": FACEOFF_K, "M": FACEOFF_M, "speedup": "ln(1+θ)",
         "fit": [a_fit, p_fit], **rates(res, wall),
         "cpu_wall_s": time.perf_counter() - t0,
         **ensemble_vs_cpu(torch, res, res_c)}
    check(res.J.device.type == dev.type and res.J.dtype == torch.float64,
          "faceoff ran off the device or out of float64")
    check_vs_cpu("faceoff", r)
    lines, gaps = faceoff_table(np, res.J.cpu().numpy(), res.policy_names)
    print(f"s(θ) = ln(1+θ)  B={B}  K={FACEOFF_K} workloads, "
          f"M≤{FACEOFF_M} jobs (heSRPT fit: {a_fit:.2f}·θ^{p_fit:.2f})",
          flush=True)
    for line in lines:
        print(line, flush=True)
    r["mean_gap_pct"] = gaps
    emit({"phase": "engine_faceoff", **r})
    check(gaps["SmartFill"] == 0.0
          and all(g > 0.0 for name, g in gaps.items() if name != "SmartFill"),
          f"faceoff: SmartFill's gap must be 0 and every baseline's > 0: "
          f"{gaps}")

    # ---- b. the engine at fleet size --------------------------------------
    kw = dict(K=FLEET_K, M=FLEET_M, B=B, m_range=(16, FLEET_M))
    fleet = sample_workloads(seed=FLEET_SEED, **kw)
    fleet_a = sample_workloads(seed=FLEET_SEED, arrival_rate=1.0, **kw)
    trace = sample_fault_traces(FLEET_FAULT_SEED, FLEET_K, FLEET_M, B=B,
                                horizon=6.0, preempt_rate=0.5, fail_rate=0.3,
                                straggle_rate=0.3)
    k = FLEET_CPU_K
    trace_c = FaultTrace(trace.times[:k], trace.kinds[:k], trace.jobs[:k],
                         trace.values[:k])
    # name: (workloads, the card's extra arguments, the CPU's)
    runs = {"plain": (fleet, {}, {}),
            "arrivals": (fleet_a, {"arrival": fleet_a.arrival},
                         {"arrival": fleet_a.arrival[:k]}),
            "faults": (fleet, {"faults": trace}, {"faults": trace_c})}
    fleet_res = {}
    for name, (w_, extra, extra_c) in runs.items():
        def run(d, w_=w_, extra=extra, k=FLEET_K):
            sp = power(1.0, 0.5, B, device=d)
            return simulate_ensemble(sp, default_zoo(sp, p_fit=0.5),
                                     w_.X[:k], w_.W[:k], device=d, **extra)

        res, wall = timed_run(lambda: run(dev))
        t0 = time.perf_counter()
        res_c = run(cpu, extra=extra_c, k=FLEET_CPU_K)
        r = {"run": name, "K": FLEET_K, "M": FLEET_M, "P": len(res),
             "speedup": "power(1, 0.5)", **rates(res, wall),
             "cpu_wall_s": time.perf_counter() - t0,
             "cpu_workloads": FLEET_CPU_K,
             **ensemble_vs_cpu(torch, res, res_c)}
        if name == "faults":
            r["fault_events"] = int(np.isfinite(trace.times).sum())
        check_vs_cpu(f"fleet {name}", r)
        if name == "plain":
            # heSRPT is optimal for a pure power at the true p: SmartFill
            # ties it (tests/core/test_ensemble.py's check)
            Jsf, Jhe = res.J[0].cpu(), res.J[1].cpu()
            r["sf_vs_hesrpt_max_abs_gap"] = float(((Jsf - Jhe) / Jhe)
                                                  .abs().max())
            check(bool((Jsf <= Jhe * (1 + 1e-9)).all()),
                  f"fleet: SmartFill above heSRPT·(1 + 1e-9): {r}")
        if on_card and name == "plain":
            wall_p, busy, n_dev, n_launch = device_profile(
                torch, lambda run=run: (run(dev), sync()))
            check(busy > 0, f"fleet {name}: the profile saw no device work")
            r.update(profiled_wall_s=wall_p, device_busy_s=busy,
                     busy_share=busy / wall_p,
                     busy_share_of_unprofiled_wall=busy / wall,
                     device_kernels=n_dev, kernel_launches=n_launch)
        fleet_res[name] = res
        emit({"phase": "engine_fleet", **r})

    # ---- c. §7 through the engine -----------------------------------------
    kw = dict(family=FAMILIES, per_job=True, m_range=(8, HSIM_M), B=B)
    hw = sample_workloads(HSIM_SEED, K=HSIM_K, M=HSIM_M, device=dev, **kw)
    hw_c = sample_workloads(HSIM_SEED, K=HSIM_K, M=HSIM_M, device=cpu, **kw)

    (pols, plan_s) = timed_run(lambda: (
        HeteroSmartFillPolicy.pinned(hw.sp, hw.X, hw.W, B=B,
                                     cache_plan=True),
        WeightedMarginalRatePolicy(hw.sp, B=B)))
    res, wall = timed_run(lambda: simulate_ensemble(hw.sp, pols, hw.X, hw.W,
                                                    device=dev))
    t0 = time.perf_counter()
    pols_c = (HeteroSmartFillPolicy.pinned(hw_c.sp, hw_c.X, hw_c.W, B=B,
                                           cache_plan=True),
              WeightedMarginalRatePolicy(hw_c.sp, B=B))
    res_c = simulate_ensemble(hw_c.sp, pols_c, hw_c.X, hw_c.W, device=cpu)
    _, sched_c = smartfill_hetero_batched(hw_c.sp, hw_c.X, hw_c.W, B=B)
    Jp, Jlin = sched_c.J, sched_c.J_linear
    realized = ((Jp - Jlin).abs() / Jp) <= 1e-9
    sim_vs_plan = (res.J[0].cpu() - Jp).abs() / Jp
    r = {"K": HSIM_K, "M": HSIM_M, "families": list(FAMILIES),
         "plan_wall_s": plan_s, **rates(res, wall),
         "cpu_wall_s": time.perf_counter() - t0,
         **ensemble_vs_cpu(torch, res, res_c),
         "orders_equal": bool(torch.equal(pols[0].rank.cpu(),
                                          pols_c[0].rank)),
         "realized": int(realized.sum()),
         "sim_vs_plan_realized": float(sim_vs_plan[realized].max()),
         "sim_vs_plan_unrealized": float(
             torch.where(realized, 0.0, sim_vs_plan).max()),
         "wmr_over_sf_mean": float((res.J[1] / res.J[0]).mean())}
    check_vs_cpu("hetero", r)
    check(r["orders_equal"], "hetero: the card's pinned orders differ")
    # Prop. 7 carried into §7: where the recursion realizes the pinned
    # order (J == J_linear), the cached table executes the plan; where
    # it does not, the table's allocations go to another active set
    check(r["realized"] > 0 and r["sim_vs_plan_realized"] <= ENGINE_RTOL,
          f"hetero: simulated J vs the plan's on realized orders {r}")
    emit({"phase": "engine_hetero", **r})

    # a budget step that invalidates the cached table: on MOVE_LANES
    # workloads, B drops to B/2 once every one of them is down to its
    # last job (after the latest second-to-last completion, halfway to
    # the next completion, so that no completion coincides with it on
    # one device and not on the other), so the workloads still running
    # re-solve their last phase (one batched per-job solve an event, the
    # costly step on the card) and the others finished on their tables
    def first(pol):
        return dataclasses.replace(
            pol, sp=map_leaves(pol.sp, lambda l: l[:MOVE_LANES]),
            rank=pol.rank[:MOVE_LANES], theta=pol.theta[:MOVE_LANES])

    ends = res.T[0, :MOVE_LANES].cpu().sort(1, descending=True).values
    span, last_but_one = ends[:, 0], ends[:, 1].max()
    t_move = float((last_but_one + span[span > last_but_one].min()) / 2)
    step = budget_trace([t_move], [B / 2])
    Xm, Wm = hw.X[:MOVE_LANES], hw.W[:MOVE_LANES]
    pm, pm_c = first(pols[0]), first(pols_c[0])
    moved, wall = timed_run(lambda: simulate_ensemble(
        pm.sp, (pm,), Xm, Wm, faults=step, device=dev))
    moved_c = simulate_ensemble(pm_c.sp, (pm_c,), Xm, Wm, faults=step,
                                device=cpu)
    late = span > t_move
    Jm, J0 = moved.J[0].cpu(), res.J[0, :MOVE_LANES].cpu()
    r = {"lanes": MOVE_LANES, "t_move": t_move, "B_after": B / 2,
         "lanes_running_at_move": int(late.sum()), "wall_s": wall,
         **ensemble_vs_cpu(torch, moved, moved_c),
         "finished_lanes_bitwise": bool(torch.equal(Jm[~late], J0[~late])),
         "running_lanes_min_rise": float((Jm[late] / J0[late] - 1).min())}
    # the host oracle (numpy loop, the policy per event on the CPU) on
    # the moved workloads
    oracle = []
    for k in torch.nonzero(late)[:, 0].tolist()[:2]:
        pk = dataclasses.replace(
            pm_c, sp=map_leaves(pm_c.sp, lambda l: l[k]), rank=pm_c.rank[k],
            theta=pm_c.theta[k])
        ref = simulate_policy_reference(pk.sp, hw.X[k], hw.W[k], pk, B=B,
                                        faults=step)
        oracle.append(abs(float(Jm[k]) - ref.J) / ref.J)
    r["vs_host_oracle"] = max(oracle)
    check_vs_cpu("cached plan under a budget step", r)
    check(r["lanes_running_at_move"] >= 1 and r["finished_lanes_bitwise"]
          and r["running_lanes_min_rise"] > 1e-6
          and r["vs_host_oracle"] <= ENGINE_RTOL,
          f"cached plan under a budget step: {r}")
    emit({"phase": "engine_cached_plan_budget_step", **r})

    # ---- d. K1 and K2 inside the engine, float32 --------------------------
    orig_auto = gwf.auto_impl

    def auto_cpu(device_type, dtype, family):
        # the CPU rehearsal: float32 takes the kernels' plain versions
        if dtype == torch.float32 and family != "other":
            return "cuda"
        return orig_auto(device_type, dtype, family)

    orig_cap = pol_mod.solve_cap_batched

    def cut_short(*a, **k):
        return orig_cap(*a, **{**k, "iters": FAULT_ITERS})

    launches = {}
    readings = {}
    # K1 under phase 3's shifted power: with a pure power θ ∝ λ^(1/γ), and
    # K1's rescale onto b undoes any error in λ, so a cut-short bisection
    # would not show
    sp_k1 = shifted_power(1.0, 4.0, 0.5, B, device=dev)
    for kname, counter, w_, pol_of in (
            ("K1", "generic_waterfill", fleet,
             lambda: GWFStaticPolicy(sp_k1, B=B)),
            ("K2", "hetero_waterfill", hw,
             lambda: WeightedMarginalRatePolicy(hw.sp, B=B))):
        sp = pol_of().sp
        ref_J = simulate_ensemble(sp, (pol_of(),), w_.X, w_.W,
                                  device=dev).J[0]
        X32 = torch.tensor(w_.X, dtype=torch.float32, device=dev)
        W32 = torch.tensor(w_.W, dtype=torch.float32, device=dev)
        out = {}
        with mock.patch.object(gwf, "auto_impl",
                               orig_auto if on_card else auto_cpu):
            for what in ("sound", "fault"):
                with mock.patch.object(pol_mod, "solve_cap_batched",
                                       orig_cap if what == "sound"
                                       else cut_short):
                    wk.reset_launches()
                    r32, wall = timed_run(lambda: simulate_ensemble(
                        sp, (pol_of(),), X32, W32, device=dev))
                    n = wk.LAUNCHES[counter]
                check(r32.J.dtype == torch.float32
                      and bool(r32.finished.all()),
                      f"{kname} float32 run: unfinished or not float32")
                out[what] = {
                    "J_rel_vs_f64": float(((r32.J[0].double() - ref_J).abs()
                                           / ref_J).max().cpu()),
                    "launches": n, "steps": int(r32.n_events.max()),
                    "wall_s": wall}
        launches[counter] = out["sound"]["launches"]
        readings[kname] = out
        if on_card:
            check(out["sound"]["launches"] >= out["sound"]["steps"] >= 1,
                  f"{kname} not launched at every event of the engine: {out}")
        check(out["sound"]["J_rel_vs_f64"] <= F32_LIMIT[kname]
              < out["fault"]["J_rel_vs_f64"],
              f"{kname} in the engine: the sound reading must be within "
              f"{F32_LIMIT[kname]} and the cut-short fault beyond: {out}")
    emit({"phase": "engine_float32_kernels", "limits": F32_LIMIT,
          "fault_iters": FAULT_ITERS, "readings": readings})
    return launches


# ---- 13. class-aggregated planning ------------------------------------------
# examples/million_jobs.py and examples/hetero_fleet.py on the card, in
# float64.  (a) one million jobs as classes through plan_classes; (b) the
# anchor at one job per class, plan_classes against smartfill_hetero
# with the class knobs, bit for bit; (c) (a)'s plan drained by the
# pinned, cached ClassSmartFillPolicy through simulate_fluid_classes,
# against the port's CPU run of the same drain; (d) 32 class instances
# through plan_classes_batched against the port's CPU run; (e) six of
# the ten configs' roofline speedups on one 256-GPU pod.
#
# (a) is cut from the example's C = 32 classes of 31,250 jobs to C = 5
# of 200,000 (the same million jobs): the per-job planner issues its
# small kernels from the host, a `_solve` at M = 32 with the class knobs
# takes ~27 s on the card (`tools/class_solve_time.py`) and plan_classes
# makes 41 of them at C = 32 (its exchange search; `--count` of the same
# tool), more than the 1200 s the whole script may take.  C = 8 (4.51
# M operations counted on the CPU, ~80 s on the card) gave way to C = 5
# (1.03 M) for phase 16's room.  J of (a) on the CPU, from
#   PYTHONPATH=src python tools/class_reference.py 1 5 200000
# (the JAX package's plan_classes compiled, its recursion op by op at
# that order, and the port's plan_classes; all three agree to 4.4e-16).
CLASS_SEED, CLASS_C, CLASS_PER = 1, 5, 200_000
CLASS_KNOBS = dict(coarse=64, descent_iters=96, cap_iters=64,
                   exchange_passes=2, exchange_window=1, stol_rel=1e-10)
J_CLASS_REF = 13375083293911.18
J_CLASS_PORT_CPU = 13375083293911.186
# (b)'s anchor plans 3 one-job classes twice (plan_classes and
# smartfill_hetero, each with its exchange search): 8 took ~86 s on the
# card, 5 about half as many device operations (aten operations counted
# on the CPU: 3.55 M against 1.63 M) and 40.6–50.1 s, 4 38.0 s; 3 (4
# until phase 19 needed the room, 5 until phase 18) took 2.9 s on the
# CPU where 4 took 11.1 s.  One job a class makes the aggregation the
# identity whatever the instance.
ANCHOR_SEED, ANCHOR_C = 5, 3
# (d)'s batch: 32 instances at this seed (64 until phase 18 needed the
# room; the sampler draws every instance's counts before any sizes, so
# the 32 share the 64's first counts, not their sizes and weights)
BATCH_SEED, BATCH_K, BATCH_C, BATCH_COUNTS = 7, 32, 16, (0, 50_000)
# (d)'s aggregates are stiff (up to 50,000 jobs a class, 58 of 64
# heuristic orders unrealized): μ* sits where F is flat and moves with
# the rounding, c and with it J_linear follow, and on unrealized orders
# J moves linearly.  The reference's compiled and op-by-op runs of this
# batch differ by up to 1.0e-4 in J_linear and 5.6e-3 in J on
# unrealized orders, 5.3e-8 on realized ones
# (tools/class_reference.py batch 7 64 16 50000).  The card is held to
# the port's CPU run a hundred times inside that, and to 1e-9 on J
# where the order is realized (J == J_linear).
BATCH_LIMITS = {"J_realized": 1e-9, "J_linear": 1e-6, "J_unrealized": 1e-4}
POD_GPUS, POD_TOKENS = 256.0, 256 * 4096
# (e)'s pod: the first six of the ten configs in name order (all ten
# until phase 19 needed the room; on the CPU six took 2.2 s where ten
# took 4.5, the plan realized at both)
CLASS_POD_JOBS = 6


def classes_phase(torch, np, dev):
    """Phase 13: class-aggregated planning on ``dev``, held against the
    same calls on the CPU (on a CPU ``dev``, a rehearsal: no profile).
    Returns the phase's kernel launches, all of which must be 0."""
    from repro_torch.configs import get_config, list_archs
    from repro_torch.core import (aggregate_classes, plan_classes,
                                  plan_classes_batched,
                                  plan_classes_reference,
                                  sample_class_workloads,
                                  simulate_fluid_classes,
                                  simulate_policy_device, smartfill_hetero,
                                  stack_speedups)
    from repro_torch.sched import (ClassSmartFillPolicy,
                                   WeightedMarginalRatePolicy)
    from repro_torch.sched.speedup_models import job_speedup

    cpu = torch.device("cpu")
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    reset_all_launches()

    # (a) one million jobs as CLASS_C classes
    C = CLASS_C
    wl = sample_class_workloads(CLASS_SEED, K=1, C=C, B=B,
                                count_range=(CLASS_PER, CLASS_PER),
                                device=dev)
    state = wl.state(0)
    t0 = time.perf_counter()
    plan = plan_classes(state)
    sync()
    wall = time.perf_counter() - t0
    check(plan.sched.theta.device.type == dev.type
          and plan.sched.theta.dtype == torch.float64,
          "the class plan ran off the device or out of float64")
    t1 = time.perf_counter()
    orc = plan_classes_reference(state, order=plan.order)
    r = {"C": C, "jobs": state.jobs, "wall_s": wall,
         "jobs_per_s": state.jobs / wall, "J": plan.J,
         "J_linear": plan.J_linear, "order": plan.order.tolist(),
         "budget_miss": abs(float(plan.theta.sum()) - B) / B,
         "J_vs_J_linear": abs(plan.J - plan.J_linear) / plan.J,
         "vs_reference": abs(plan.J - J_CLASS_REF) / J_CLASS_REF,
         "vs_port_cpu": abs(plan.J - J_CLASS_PORT_CPU) / J_CLASS_PORT_CPU,
         "oracle_J": orc.J, "oracle_minus_J": (orc.J - plan.J) / plan.J,
         "oracle_wall_s": time.perf_counter() - t1}
    emit({"phase": "classes_million", **r})
    check(state.jobs == 1_000_000, f"(a) plans {state.jobs} jobs")
    check(r["budget_miss"] <= 1e-9, f"class plan: Σθ ≠ B {r['budget_miss']}")
    check(r["J_vs_J_linear"] <= 1e-9,
          f"class plan: J vs J_linear {r['J_vs_J_linear']}")
    check(r["vs_reference"] <= 1e-9,
          f"class plan: J vs the JAX package's {r['vs_reference']}")
    check(r["vs_port_cpu"] <= 1e-9,
          f"class plan: J vs the port's CPU run {r['vs_port_cpu']}")
    check(orc.J >= plan.J * (1 - 1e-8),
          f"class plan: the numpy oracle beats the plan by "
          f"{-r['oracle_minus_J']}")
    if on_card:
        # one solve of the plan's aggregates (the plan makes 10 such, one
        # a step of its exchange search): the trace of the whole plan,
        # ~5 M device records, costs minutes to stop and read
        sp_agg, X, W = aggregate_classes(state)
        kw = {**CLASS_KNOBS, "exchange_passes": 0}
        w_p, busy, n_dev, n_launch = device_profile(
            torch, lambda: (smartfill_hetero(sp_agg, X, W, B=B, **kw),
                            sync()))
        check(busy > 0, "the class solve's profile saw no device work")
        emit({"phase": "classes_solve_profile", "wall_s": w_p,
              "device_busy_s": busy, "busy_share": busy / w_p,
              "device_kernels": n_dev, "kernel_launches": n_launch})

    # (b) the anchor: one job per class is the per-job plan, bit for bit
    wl1 = sample_class_workloads(ANCHOR_SEED, K=1, C=ANCHOR_C, B=B,
                                 count_range=(1, 1), device=dev)
    s1 = wl1.state(0)
    t0 = time.perf_counter()
    cls = plan_classes(s1)
    per = smartfill_hetero(s1.sp, s1.sizes, s1.weights, B=B, **CLASS_KNOBS)
    sync()
    r = {"C": ANCHOR_C, "wall_s": time.perf_counter() - t0, "J": cls.J,
         "per_job_J": per.J, "order": cls.order.tolist()}
    emit({"phase": "classes_anchor", **r})
    check(cls.J == per.J and cls.J_linear == per.J_linear
          and np.array_equal(cls.order, per.order)
          and np.array_equal(cls.T[cls.order], per.T.cpu().numpy())
          and torch.equal(cls.sched.theta, per.theta),
          f"anchor: the class plan is not the per-job plan bit for bit {r}")

    # (c) the fluid drain of (a)'s plan, card against CPU
    wl_c = sample_class_workloads(CLASS_SEED, K=1, C=C, B=B,
                                  count_range=(CLASS_PER, CLASS_PER),
                                  device=cpu)
    drains = {}
    for d, st in ((dev, state), (cpu, wl_c.state(0))):
        pol = ClassSmartFillPolicy._from_plan(st, plan, cache_plan=True)
        t0 = time.perf_counter()
        drains[d.type] = simulate_fluid_classes(st, pol)
        sync()
        drains[d.type + "_wall_s"] = time.perf_counter() - t0
    res, res_c = drains[dev.type], drains["cpu"]
    r = {"events": res.n_events, "finished": res.finished,
         "J_jobs": res.J_jobs, "J_fluid": res.J_fluid,
         "J_fluid_over_J_jobs": res.J_fluid / res.J_jobs,
         "J_jobs_vs_plan": abs(res.J_jobs - plan.J) / plan.J,
         "T_vs_cpu": float(np.max(np.abs(res.T - res_c.T) / res_c.T)),
         "J_fluid_vs_cpu": abs(res.J_fluid - res_c.J_fluid) / res_c.J_fluid,
         "wall_s": drains[dev.type + "_wall_s"]}
    emit({"phase": "classes_fluid", **r})
    check(res.finished and res.n_events == C,
          f"fluid drain: finished {res.finished}, {res.n_events} events "
          f"(expected {C})")
    check(r["J_jobs_vs_plan"] <= 1e-9, f"fluid drain vs the plan {r}")
    check(res.J_fluid <= res.J_jobs * (1 + 1e-12),
          f"fluid drain: J_fluid above J_jobs {r}")
    check(r["T_vs_cpu"] <= 1e-9 and r["J_fluid_vs_cpu"] <= 1e-9
          and res.n_events == res_c.n_events,
          f"fluid drain: card vs CPU {r}")

    # (d) a batch of class instances, card against CPU
    batches = [sample_class_workloads(BATCH_SEED, K=BATCH_K, C=BATCH_C, B=B,
                                      count_range=BATCH_COUNTS, device=d)
               for d in (dev, cpu)]
    t0 = time.perf_counter()
    orders, sched = plan_classes_batched(
        batches[0].counts, batches[0].sizes, batches[0].weights,
        batches[0].sp, B=B)
    sync()
    wall = time.perf_counter() - t0
    orders_c, sched_c = plan_classes_batched(
        batches[1].counts, batches[1].sizes, batches[1].weights,
        batches[1].sp, B=B)
    Jg, Jc = sched.J.cpu(), sched_c.J
    Jlin, Jlin_c = sched.J_linear.cpu(), sched_c.J_linear
    realized = ((Jc - Jlin_c).abs() / Jc) <= 1e-9
    rel = (Jg - Jc).abs() / Jc
    jobs = float(batches[0].jobs.sum())
    r = {"K": BATCH_K, "C": BATCH_C, "jobs": jobs, "wall_s": wall,
         "jobs_per_s": jobs / wall, "realized": int(realized.sum()),
         "J_realized": float(torch.where(realized, rel, 0.0).max()),
         "J_unrealized": float(torch.where(realized, 0.0, rel).max()),
         "J_linear": float(((Jlin - Jlin_c).abs() / Jlin_c).max()),
         "J_below_J_linear": float((Jlin * (1 - 1e-9) - Jg).clamp_min(0)
                                   .max()),
         "limits": BATCH_LIMITS}
    emit({"phase": "classes_batched", **r})
    check(np.array_equal(orders, orders_c),
          "class batch: the card's orders differ from the CPU run's")
    check(all(r[k] <= lim for k, lim in BATCH_LIMITS.items()),
          f"class batch: card vs CPU {r}")
    check(r["J_below_J_linear"] == 0.0,
          "class batch: J below J_linear·(1 − 1e-9)")

    # (e) examples/hetero_fleet.py: CLASS_POD_JOBS configs on one
    # 256-GPU pod
    names = sorted(list_archs())[:CLASS_POD_JOBS]

    def pod(d):
        members = []
        for arch in names:
            cfg = get_config(arch)
            members.append(job_speedup(
                step_flops=6.0 * cfg.active_param_count() * POD_TOKENS,
                grad_bytes=2.0 * cfg.param_count(),
                tokens_per_step=POD_TOKENS, B=POD_GPUS, device=d))
        sp = stack_speedups(members, B=POD_GPUS)
        x = np.random.default_rng(0).uniform(2, 15, len(names)) * 1e9
        rate = sp.s(torch.full((len(names),), POD_GPUS, dtype=torch.float64,
                               device=d)).cpu().numpy()
        return sp, x, rate / x

    sp, x, w = pod(dev)
    t0 = time.perf_counter()
    fleet = smartfill_hetero(sp, x, w, B=POD_GPUS, exchange_passes=2)
    sync()
    wall = time.perf_counter() - t0
    sp_c, _, _ = pod(cpu)
    fleet_c = smartfill_hetero(sp_c, x, w, B=POD_GPUS, exchange_passes=2)
    wmr = simulate_policy_device(
        sp, x, w, WeightedMarginalRatePolicy(sp, B=POD_GPUS), B=POD_GPUS)
    r = {"jobs": len(names), "wall_s": wall, "J": fleet.J,
         "J_linear": fleet.J_linear,
         "order": [names[i] for i in fleet.order],
         "J_vs_J_linear": abs(fleet.J - fleet.J_linear) / fleet.J,
         "card_vs_cpu": abs(fleet.J - fleet_c.J) / fleet_c.J,
         "wmr_J": wmr.J, "wmr_over_plan": wmr.J / fleet.J - 1.0}
    emit({"phase": "classes_hetero_fleet", **r})
    check(r["J_vs_J_linear"] <= 1e-9, f"hetero fleet: J vs J_linear {r}")
    check(np.array_equal(fleet.order, fleet_c.order)
          and r["card_vs_cpu"] <= 1e-9, f"hetero fleet: card vs CPU {r}")
    check(wmr.J >= fleet.J * (1 - 1e-12),
          f"hetero fleet: WMR below the plan {r}")
    launches = all_launches()
    check(not any(launches.values()),
          f"a kernel was launched in the class phase: {launches}")
    return launches


# ---- 14. the robustness layer, fleet planning at D = 1, admission -----------
# Float64 throughout, so no K1–K5 launch.  (a) the certified ladder
# (SmartFill → GWF-static → EQUI) on phase 12(b)'s plain fleet, bit for
# bit equal to SmartFill alone, with its cost an event beside SmartFill's;
# then degradation_report on a face-off instance of ≥ 6 live jobs,
# card and CPU, all events on rung 0; (b) the same ladder with its
# primary sabotaged (NaN, overspend, negative while more than four jobs
# are active) over the face-off's 128 workloads, card against CPU, and
# the rung counts of the instance, which must show rung 1; (c)
# certify_plan on phase 5's quickstart schedule and on the largest plan
# of phase 11's per-job fleet, and two planted faults that must fail on
# the field they break; (d) examples/fleet_sweep.py on a one-card mesh:
# plan_sharded (1000 instances in chunks of 192), simulate_ensemble_sharded
# (256 workloads in chunks of 60, with arrivals and with a fault trace
# each, under √θ: see (d)) and
# plan_classes_sharded (5 class instances in chunks of 3), each held bit
# for bit to its unsharded call on the card and to the port's CPU run;
# (e) examples/batched_planning.py §3's admission control on the card
# against the CPU, the simulate estimator with and without a fleet mesh,
# a deep queue (32 running, 255 candidates: 256 instances of 33 jobs in
# one batched solve), mixed-model scoring over the ten configs' speedups,
# and the watchdog in virtual time.
ROBUST_RTOL = 1e-6        # card vs CPU, the engine's (phase 12)
ADMIT_RTOL = 1e-9         # admission ΔJ, card vs CPU
SWEEP_K, SWEEP_M, SWEEP_CHUNK = 1000, 16, 192
ENS_K, ENS_M, ENS_CHUNK, ENS_SEED, ENS_FAULT_SEED = 256, 8, 60, 1, 2
# The sharded class batch (d) is five instances of five classes in
# chunks of 3 (two chunks, one padded row) and the degradation reports
# (a, b) run on one face-off instance: each chunk is a whole
# launch-bound call (~8 s) and each sabotaged report ~3 s an instance on
# the card, cut from eight instances, eight classes (0.72 M operations
# against 1.36 M counted on the CPU) and four reports to keep the whole
# script within its time (PERF.md §4).
CLS_SEED, CLS_K, CLS_C, CLS_CHUNK = 7, 5, 5, 3
QUEUE_R, QUEUE_C, QUEUE_SEED = 32, 255, 14
SABOTAGE_MIN_ACTIVE = 4
REPORT_N, REPORT_MIN_LIVE = 1, 6


def timed_call(sync, run):
    """(run(), wall s) of one call on the device, synchronised."""
    t0 = time.perf_counter()
    out = run()
    sync()
    return out, time.perf_counter() - t0


class VirtualClock:
    """The watchdog's sleep and clock in virtual time."""

    def __init__(self):
        self.t = 0.0
        self.sleeps = []

    def sleep(self, s):
        self.sleeps.append(s)
        self.t += s

    def clock(self):
        return self.t


def admission_example_candidates(np):
    """examples/batched_planning.py §3's six candidates: its generator
    (seed 0) after §1's fleet and §2's eight cluster fleets."""
    rng = np.random.default_rng(0)
    for m in rng.integers(2, 17, 256):
        rng.uniform(0.5, 20.0, m)
    for _ in range(8):
        rng.uniform(50.0, 500.0, int(rng.integers(2, 7)))
    return rng.uniform(0.5, 15.0, 6)


def same_bits(torch, a, b, fields):
    """Fields of two results that differ in any bit, with the largest
    relative difference of each (empty when every field is equal)."""
    out = {}
    for f in fields:
        x, y = getattr(a, f), getattr(b, f).to(getattr(a, f).device)
        if not torch.equal(x, y):
            d = (x.double() - y.double()).abs()
            out[f] = float((d / y.double().abs().clamp_min(1e-300))
                           .nan_to_num(0.0).max())
    return out


def robust_phase(torch, np, dev, quickstart=None, hetero_fleet=None):
    """Phase 14 on ``dev``, held against the same calls on the CPU (on a
    CPU ``dev``, a rehearsal: no profile, a one-device CPU mesh).
    ``quickstart`` is phase 5's schedule and ``hetero_fleet`` phase 11's
    (workloads, orders, schedule); without them the phase plans both
    itself.  Returns the phase's kernel launches, all of which must be
    0."""
    import dataclasses

    from repro_torch.core import (log_speedup, power, sample_class_workloads,
                                  sample_fault_traces, sample_workloads,
                                  simulate_ensemble, smartfill,
                                  smartfill_batched, smartfill_hetero_batched,
                                  plan_classes_batched, stack_speedups)
    from repro_torch.core.speedup import map_leaves
    from repro_torch.configs import get_config, list_archs
    from repro_torch.distributed import (fleet_mesh, plan_classes_sharded,
                                         plan_sharded,
                                         simulate_ensemble_sharded)
    from repro_torch.distributed.fleet import _chunk_layout
    from repro_torch.robust import (DegradingPolicy, SaboteurPolicy,
                                    Watchdog, certify_plan,
                                    degradation_report)
    from repro_torch.sched import EquiPolicy, HeSRPTPolicy, SmartFillPolicy
    from repro_torch.sched.speedup_models import job_speedup
    from repro_torch.serve import admission as adm

    cpu = torch.device("cpu")
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    reset_all_launches()

    def timed_run(run):
        return timed_call(sync, run)

    # ---- a. the ladder, healthy, at fleet size ----------------------------
    fleet = sample_workloads(seed=FLEET_SEED, K=FLEET_K, M=FLEET_M, B=B,
                             m_range=(16, FLEET_M))
    sp_pow = power(1.0, 0.5, B, device=dev)
    pols = {"SmartFill": SmartFillPolicy(sp_pow, B=B),
            "ladder": DegradingPolicy.ladder(sp_pow, B=B)}
    res, r = {}, {}
    for name, pol in pols.items():
        def run(pol=pol):
            return simulate_ensemble(sp_pow, (pol,), fleet.X, fleet.W,
                                     device=dev)
        res[name], wall = timed_run(run)
        steps = int(res[name].n_events.max())
        r[name] = {"wall_s": wall, "steps": steps,
                   "events": int(res[name].n_events.sum())}
        if on_card:
            wall_p, busy, n_dev, n_launch = device_profile(
                torch, lambda run=run: (run(), sync()))
            check(busy > 0, f"ladder {name}: the profile saw no device work")
            r[name].update(profiled_wall_s=wall_p, device_busy_s=busy,
                           busy_share=busy / wall_p,
                           device_kernels=n_dev, kernel_launches=n_launch,
                           kernels_per_step=n_dev / steps)
    diff = same_bits(torch, res["ladder"], res["SmartFill"],
                     ("J", "T", "n_events"))
    r.update(K=FLEET_K, M=FLEET_M, speedup="power(1, 0.5)",
             ladder_over_smartfill_wall=(r["ladder"]["wall_s"]
                                         / r["SmartFill"]["wall_s"]),
             bit_for_bit=not diff, differs=diff,
             all_finished=bool(res["ladder"].finished.all()))
    emit({"phase": "robust_ladder_healthy", **r})
    check(not diff and r["all_finished"],
          f"the healthy ladder is not SmartFill bit for bit: {diff}")

    # the first face-off instance (ln(1+θ)) with ≥ REPORT_MIN_LIVE jobs
    fo = sample_workloads(seed=FACEOFF_SEED, K=FACEOFF_K, M=FACEOFF_M, B=B,
                          m_range=(3, FACEOFF_M))
    picks = [int(k) for k in np.flatnonzero(fo.m >= REPORT_MIN_LIVE)
             [:REPORT_N]]

    def reports(lad_of, d):
        sp = log_speedup(1.0, 1.0, B, device=d)
        lad = lad_of(sp)
        return [degradation_report(sp, fo.X[k], fo.W[k], lad, B=B)
                for k in picks]

    def healthy(sp):
        return DegradingPolicy.ladder(sp, B=B)

    (reps, wall) = timed_run(lambda: reports(healthy, dev))
    reps_c = reports(healthy, cpu)
    r = {"instances": picks, "live_jobs": [int(fo.m[k]) for k in picks],
         "wall_s": wall,
         "rung_counts": [rep["rung_counts"] for rep in reps],
         "rung_counts_cpu": [rep["rung_counts"] for rep in reps_c],
         "n_events": [rep["n_events"] for rep in reps]}
    emit({"phase": "robust_report_healthy", **r})
    check(all(rep["rung_counts"] == {0: rep["n_events"]}
              for rep in reps + reps_c),
          f"healthy degradation reports left rung 0: {r}")

    # ---- b. the ladder under a sabotaged primary --------------------------
    for mode in SaboteurPolicy.MODES:
        def sabotaged(sp, mode=mode):
            primary = SaboteurPolicy(SmartFillPolicy(sp, B=B), mode=mode,
                                     min_active=SABOTAGE_MIN_ACTIVE)
            return DegradingPolicy.ladder(sp, B=B, primary=primary)

        def run(d, sabotaged=sabotaged):
            sp = log_speedup(1.0, 1.0, B, device=d)
            return simulate_ensemble(sp, (sabotaged(sp),), fo.X, fo.W,
                                     device=d)

        out, wall = timed_run(lambda: run(dev))
        t0 = time.perf_counter()
        out_c = run(cpu)
        cpu_s = time.perf_counter() - t0
        reps, rwall = timed_run(lambda: reports(sabotaged, dev))
        reps_c = reports(sabotaged, cpu)
        r = {"mode": mode, "min_active": SABOTAGE_MIN_ACTIVE,
             "K": FACEOFF_K, "M": FACEOFF_M, "wall_s": wall,
             "cpu_wall_s": cpu_s, **ensemble_vs_cpu(torch, out, out_c),
             "report_wall_s": rwall,
             "rung_counts": [rep["rung_counts"] for rep in reps],
             "rung_counts_cpu": [rep["rung_counts"] for rep in reps_c]}
        emit({"phase": "robust_sabotaged", **r})
        check_vs_cpu(f"sabotaged ({mode})", r)
        check(r["rung_counts"] == r["rung_counts_cpu"]
              and all(c.get(1, 0) > 0 for c in r["rung_counts"]),
              f"sabotaged ({mode}): rung counts card vs CPU, or no event "
              f"on rung 1: {r}")

    # ---- c. plan certificates ---------------------------------------------
    sp_log = log_speedup(1.0, 1.0, B, device=dev)
    if quickstart is None:
        x8 = np.arange(8, 0, -1.0) * 2.0
        quickstart = smartfill(sp_log, x8, 1.0 / x8, B=B)
    if hetero_fleet is None:
        from repro_torch.core import FAMILIES
        wl = sample_workloads(HETERO_SEED, K=HETERO_N, M=HETERO_M,
                              family=FAMILIES, per_job=True,
                              m_range=(2, HETERO_M), B=B, device=dev)
        n0 = int(np.argmax(wl.m))
        one = map_leaves(wl.sp, lambda l: l[n0:n0 + 1])
        orders, sched = smartfill_hetero_batched(
            one, wl.X[n0:n0 + 1], wl.W[n0:n0 + 1], B=B,
            active=wl.active[n0:n0 + 1])
        row = 0
    else:
        wl, orders, sched = hetero_fleet
        n0 = row = int(np.argmax(wl.m))
    m0 = int(wl.m[n0])
    o = torch.as_tensor(np.asarray(orders[row][:m0]), device=dev)
    sp_rank = map_leaves(wl.sp, lambda l: l[n0][o])
    inst = sched.instance(row)
    per_job = dataclasses.replace(inst, theta=inst.theta[:m0, :m0],
                                  c=inst.c[:m0], a=inst.a[:m0])
    realized = abs(per_job.J - per_job.J_linear) / per_job.J <= 1e-9

    def reading(cert, tol):
        return {"ok": cert.ok, "finite": cert.finite, "budget": cert.budget,
                "kkt": cert.kkt, "j_gap": cert.j_gap, "tol": tol}

    tol = 1e-6
    certs = {}
    t0 = time.perf_counter()
    certs["quickstart"] = reading(certify_plan(sp_log, quickstart, B=B,
                                               tol=tol), tol)
    certs["per_job_largest"] = reading(certify_plan(
        sp_rank, per_job, B=B, tol=tol, check_j_gap=realized), tol)
    certs["per_job_largest"].update(M=m0, realized=bool(realized))
    th = quickstart.theta.clone()
    th[:, 3] = th[:, 3] * 1.01
    certs["fault_column_x1.01"] = reading(certify_plan(
        sp_log, dataclasses.replace(quickstart, theta=th), B=B, tol=tol),
        tol)
    th = quickstart.theta.clone()
    top = torch.argsort(th[:, -1], descending=True)[:2]   # two served jobs
    th[top, -1] = th[top.flip(0), -1]
    certs["fault_swap_two_jobs"] = reading(certify_plan(
        sp_log, dataclasses.replace(quickstart, theta=th), B=B, tol=tol),
        tol)
    emit({"phase": "robust_certificates", "wall_s":
          time.perf_counter() - t0, **certs})
    check(certs["quickstart"]["ok"] and certs["per_job_largest"]["ok"],
          f"a sound plan failed its certificate: {certs}")
    bad = certs["fault_column_x1.01"]
    check(not bad["ok"] and bad["budget"] > tol,
          f"the scaled column must fail on the budget: {bad}")
    bad = certs["fault_swap_two_jobs"]
    check(not bad["ok"] and bad["budget"] <= tol
          and max(bad["kkt"].values()) > tol,
          f"the swapped allocations must fail on the KKT rows alone: {bad}")

    # ---- d. fleet planning on a one-card mesh -----------------------------
    mesh = fleet_mesh() if on_card else fleet_mesh(device="cpu")
    check(mesh.size == 1, f"the fleet mesh is not one device: {mesh}")
    sweep = sample_workloads(0, K=SWEEP_K, M=SWEEP_M, B=B, m_range=(4, 16))
    fields = ("theta", "c", "a", "durations", "T", "J", "J_linear")
    total, chunks, _ = _chunk_layout(SWEEP_K, 1, SWEEP_CHUNK)
    sh, wall = timed_run(lambda: plan_sharded(
        sp_log, sweep.X, sweep.W, B=B, mesh=mesh, chunk_size=SWEEP_CHUNK))
    ref, ref_wall = timed_run(lambda: smartfill_batched(
        sp_log, sweep.X, sweep.W, B=B))
    sp_c = log_speedup(1.0, 1.0, B, device=cpu)
    ref_c = smartfill_batched(sp_c, sweep.X, sweep.W, B=B)
    diff = same_bits(torch, sh, ref, fields)
    r = {"call": "plan_sharded", "K": SWEEP_K, "M": SWEEP_M,
         "chunk_size": SWEEP_CHUNK, "chunks": chunks,
         "padded": total - SWEEP_K, "wall_s": wall,
         "unsharded_wall_s": ref_wall, "bit_for_bit": not diff,
         "differs": diff,
         "J_vs_cpu": float(((sh.J.cpu() - ref_c.J).abs()
                            / ref_c.J.clamp_min(1e-300)).max()),
         "rows_finite": bool(torch.isfinite(sh.theta).all())}
    emit({"phase": "fleet_plan_sharded", **r})
    check(not diff, f"plan_sharded vs smartfill_batched on the card: {r}")
    check(r["J_vs_cpu"] <= 1e-9, f"plan_sharded vs the CPU: {r}")

    ens = sample_workloads(ENS_SEED, K=ENS_K, M=ENS_M, B=B, m_range=(2, 8),
                           arrival_rate=0.5)
    traces = sample_fault_traces(ENS_FAULT_SEED, ENS_K, ENS_M, B=B,
                                 horizon=4.0, preempt_rate=0.3,
                                 fail_rate=0.2, straggle_rate=0.2)
    total, chunks, _ = _chunk_layout(ENS_K, 1, ENS_CHUNK)
    for name, extra in (("arrivals", {"arrival": ens.arrival}),
                        ("faults", {"faults": traces})):
        def zoo(d):
            # √θ, not the example's ln(1+θ): SmartFill's generic-μ*
            # re-plan costs ~0.45 s an event on the card, its closed-form
            # μ* (a pure power) ~0.06 s; six event loops a run (five
            # chunks and the unsharded call) made these two calls 95 s
            sp = power(1.0, 0.5, B, device=d)
            return sp, (SmartFillPolicy(sp, B=B), HeSRPTPolicy(0.5, B),
                        EquiPolicy(B))

        sp_d, zoo_d = zoo(dev)
        sh, wall = timed_run(lambda: simulate_ensemble_sharded(
            sp_d, zoo_d, ens.X, ens.W, B=B, mesh=mesh,
            chunk_size=ENS_CHUNK, **extra))
        ref, ref_wall = timed_run(lambda: simulate_ensemble(
            sp_d, zoo_d, ens.X, ens.W, B=B, device=dev, **extra))
        sp_cc, zoo_c = zoo(cpu)
        ref_c = simulate_ensemble(sp_cc, zoo_c, ens.X, ens.W, B=B,
                                  device=cpu, **extra)
        diff = same_bits(torch, sh, ref,
                         ("J", "T", "finished", "n_events", "exhausted"))
        r = {"call": "simulate_ensemble_sharded", "run": name, "K": ENS_K,
             "M": ENS_M, "P": 3, "speedup": "power(1, 0.5)",
             "chunk_size": ENS_CHUNK, "chunks": chunks,
             "padded": total - ENS_K, "wall_s": wall,
             "unsharded_wall_s": ref_wall, "bit_for_bit": not diff,
             "differs": diff, **ensemble_vs_cpu(torch, sh, ref_c)}
        emit({"phase": "fleet_ensemble_sharded", **r})
        check(not diff, f"simulate_ensemble_sharded ({name}) vs "
              f"simulate_ensemble on the card: {r}")
        check_vs_cpu(f"simulate_ensemble_sharded ({name})", r)

    def classes(d):
        return sample_class_workloads(CLS_SEED, K=CLS_K, C=CLS_C, B=B,
                                      count_range=(0, 50_000), device=d)

    cw = classes(dev)
    total, chunks, _ = _chunk_layout(CLS_K, 1, CLS_CHUNK)
    (o_sh, sh), wall = timed_run(lambda: plan_classes_sharded(
        cw.counts, cw.sizes, cw.weights, cw.sp, B=B, mesh=mesh,
        chunk_size=CLS_CHUNK))
    (o_ref, ref), ref_wall = timed_run(lambda: plan_classes_batched(
        cw.counts, cw.sizes, cw.weights, cw.sp, B=B))
    cwc = classes(cpu)
    o_c, ref_c = plan_classes_batched(cwc.counts, cwc.sizes, cwc.weights,
                                      cwc.sp, B=B)
    diff = same_bits(torch, sh, ref, fields)
    r = {"call": "plan_classes_sharded", "K": CLS_K, "C": CLS_C,
         "chunk_size": CLS_CHUNK, "chunks": chunks, "padded": total - CLS_K,
         "wall_s": wall, "unsharded_wall_s": ref_wall,
         "orders_equal": bool(np.array_equal(o_sh, o_ref)),
         "orders_equal_cpu": bool(np.array_equal(o_sh, o_c)),
         "bit_for_bit": not diff, "differs": diff,
         "J_vs_cpu": float(((sh.J.cpu() - ref_c.J).abs()
                            / ref_c.J.clamp_min(1e-300)).max())}
    emit({"phase": "fleet_classes_sharded", **r})
    check(r["orders_equal"] and not diff,
          f"plan_classes_sharded vs plan_classes_batched on the card: {r}")

    # ---- e. admission control ---------------------------------------------
    running = np.array([9.0, 6.0, 3.0])
    cands = admission_example_candidates(np)
    args = (running, 1.0 / running, cands, 1.0 / cands)
    ac = adm.AdmissionController(sp_log, B)
    ac_c = adm.AdmissionController(sp_c, B)
    dec, wall = timed_run(lambda: ac.evaluate(*args))
    dec_c = ac_c.evaluate(*args)
    best = ac.admit_best(*args, k=2)
    best_c = ac_c.admit_best(*args, k=2)
    rel = float(np.max(np.abs(dec.marginal_cost - dec_c.marginal_cost)
                       / np.abs(dec_c.marginal_cost)))
    r = {"running": running.tolist(), "candidates": cands.tolist(),
         "wall_s": wall, "baseline_J": dec.baseline_J,
         "marginal_cost": dec.marginal_cost.tolist(),
         "admit_best_2": best.tolist(), "admit_best_2_cpu": best_c.tolist(),
         "dJ_vs_cpu": rel, "limit": ADMIT_RTOL}
    emit({"phase": "admission_example", **r})
    check(rel <= ADMIT_RTOL and np.array_equal(best, best_c)
          and np.array_equal(dec.admit, dec_c.admit),
          f"admission card vs CPU: {r}")

    ac_s = adm.AdmissionController(sp_log, B, estimator="simulate")
    sim, wall = timed_run(lambda: ac_s.evaluate(*args))
    with fleet_mesh() if on_card else fleet_mesh(device="cpu"):
        sim_mesh, mesh_wall = timed_run(lambda: ac_s.evaluate(*args))
    r = {"wall_s": wall, "mesh_wall_s": mesh_wall,
         "simulate_vs_plan": float(np.max(
             np.abs(sim.marginal_cost - dec.marginal_cost)
             / np.abs(dec.marginal_cost))),
         "mesh_bit_for_bit": bool(np.array_equal(sim.marginal_cost,
                                                 sim_mesh.marginal_cost)
                                  and sim.baseline_J == sim_mesh.baseline_J),
         "limit": ROBUST_RTOL}
    emit({"phase": "admission_simulate", **r})
    check(r["simulate_vs_plan"] <= ROBUST_RTOL and r["mesh_bit_for_bit"],
          f"admission simulate estimator: {r}")

    rng = np.random.default_rng(QUEUE_SEED)
    q_run = rng.uniform(0.5, 20.0, QUEUE_R)
    q_cand = rng.uniform(0.5, 20.0, QUEUE_C)
    q_args = (q_run, 1.0 / q_run, q_cand, 1.0 / q_cand)
    qd, wall = timed_run(lambda: ac.evaluate(*q_args))
    t0 = time.perf_counter()
    qd_c = ac_c.evaluate(*q_args)
    r = {"running": QUEUE_R, "candidates": QUEUE_C,
         "instances": QUEUE_C + 1, "M": QUEUE_R + 1, "wall_s": wall,
         "cpu_wall_s": time.perf_counter() - t0,
         "dJ_vs_cpu": float(np.max(np.abs(qd.marginal_cost
                                          - qd_c.marginal_cost)
                                   / np.abs(qd_c.marginal_cost))),
         "admitted_equal": bool(np.array_equal(qd.admit, qd_c.admit)),
         "limit": ADMIT_RTOL}
    emit({"phase": "admission_deep_queue", **r})
    check(r["dJ_vs_cpu"] <= ADMIT_RTOL and r["admitted_equal"],
          f"deep admission queue card vs CPU: {r}")

    names = sorted(list_archs())

    def models(d):
        return [job_speedup(
            step_flops=6.0 * get_config(a).active_param_count() * POD_TOKENS,
            grad_bytes=2.0 * get_config(a).param_count(),
            tokens_per_step=POD_TOKENS, B=POD_GPUS, device=d) for a in names]

    def mixed(d):
        sps = models(d)
        x = np.random.default_rng(0).uniform(2, 15, len(names)) * 1e9
        rate = stack_speedups(sps, B=POD_GPUS).s(torch.full(
            (len(names),), POD_GPUS, dtype=torch.float64,
            device=d)).cpu().numpy()
        w = rate / x
        ctl = adm.AdmissionController(sps[0], B=POD_GPUS)
        return ctl.evaluate(x[:4], w[:4], x[4:], w[4:],
                            running_speedups=sps[:4],
                            cand_speedups=sps[4:])

    md, wall = timed_run(lambda: mixed(dev))
    md_c = mixed(cpu)
    r = {"running": names[:4], "candidates": names[4:], "wall_s": wall,
         "marginal_cost": md.marginal_cost.tolist(),
         "dJ_vs_cpu": float(np.max(np.abs(md.marginal_cost
                                          - md_c.marginal_cost)
                                   / np.abs(md_c.marginal_cost))),
         "limit": ADMIT_RTOL}
    emit({"phase": "admission_mixed_models", **r})
    check(r["dJ_vs_cpu"] <= ADMIT_RTOL
          and bool(np.isfinite(md.marginal_cost).all()),
          f"mixed-model admission card vs CPU: {r}")

    # the watchdog: a score that raises twice, then one that returns NaN
    real = adm.smartfill_batched
    calls = {"n": 0}

    def flaky(*a, **k):
        calls["n"] += 1
        if calls["n"] <= 2:
            raise RuntimeError("injected fault")
        return real(*a, **k)

    def poisoned(*a, **k):
        out = real(*a, **k)
        return dataclasses.replace(out, J=torch.full_like(out.J, torch.nan))

    r = {}
    for name, score in (("raises_twice", flaky), ("returns_nan", poisoned)):
        vc = VirtualClock()
        wd = Watchdog(retries=3, backoff_s=0.05, jitter=0.1, seed=0,
                      sleep=vc.sleep, clock=vc.clock)
        with mock.patch.object(adm, "smartfill_batched", score):
            d = adm.AdmissionController(sp_log, B, watchdog=wd).evaluate(
                *args)
        r[name] = {"status": d.status, "admit": d.admit.tolist(),
                   "stats": wd.stats, "sleeps": vc.sleeps,
                   "undisturbed": bool(np.array_equal(d.marginal_cost,
                                                      dec.marginal_cost))}
    emit({"phase": "admission_watchdog", **r})
    check(r["raises_twice"]["status"] == "ok"
          and r["raises_twice"]["undisturbed"]
          and r["raises_twice"]["stats"]["failures"] == 2,
          f"watchdog: a score that raised twice {r['raises_twice']}")
    nan = r["returns_nan"]
    check(nan["status"].startswith("degraded:") and not any(nan["admit"])
          and nan["stats"]["rejections"] == 4,
          f"watchdog: a score that returns NaN {nan}")

    launches = all_launches()
    check(not any(launches.values()),
          f"a kernel was launched in the robustness phase: {launches}")
    return launches


# ---- 15. the streaming control plane and the fleet's stream service ------
# Slice E (serve/stream.py with the streaming half of sched/policies.py)
# and slice F2 (distributed/fleet.py::serve_streams_sharded), float64
# under s = √θ (the closed-form μ*) with B = 10: (a) the committed trace
# benchmarks/traces/arrivals_sample.csv and (b) the quick day trace of
# benchmarks/perf_serve.py::bench_stream, each through the host loop
# with StreamCascadePolicy, through run_device and through run_device in
# chunks of 17 events (bit for bit among the three on the card; the
# CPU's run_device: the same counts, completions and J to 1e-9); (c)
# (b)'s trace under the default StreamingSmartFillPolicy, card against
# CPU; (d) a primary planner that raises: every replan on the ladder;
# (e) serve_streams_sharded at D = 1 over the quick multi-tenant traces
# of perf_serve.bench_multitenant_worker, each tenant bit for bit to its
# solo run_device, the admission view equal to the CPU's.  For the room
# of later phases (b)'s trace stops at 2700 s of its 7200 s day (3600 s
# until phase 19, 247 arrivals of 449, every one completed on the CPU;
# at 1800 s an arrival would still be running at its end) and (e) runs
# two of the four tenants for 900 s of their 1800 s (PERF.md §4).
STREAM_M = 8
STREAM_RTOL = 1e-9        # card vs CPU: completion times and weighted J
STREAM_TRACE = "benchmarks/traces/arrivals_sample.csv"
DAY_TRACE = dict(seed=17, horizon=2700.0, rate=0.12, diurnal=0.75,
                 period=7200.0, n_budget_events=2, budget_frac=(0.3, 0.8),
                 deadline_slack=50.0)
BROKEN_TRACE, BROKEN_M = dict(seed=5, horizon=4000.0, rate=0.01), 4
TENANT_SEEDS, TENANT_HORIZON, TENANT_PERIOD = (17, 18), 900.0, 1800.0
PROFILE_EVENTS = 20
STREAM_COUNTERS = ("replans", "warm_replans", "cold_replans",
                   "degraded_windows", "n_events")


def stream_diff(np, a, b):
    """The fields in which two StreamResults differ in any bit."""
    out = [f for f in STREAM_COUNTERS if getattr(a, f) != getattr(b, f)]
    if not np.array_equal(a.completion, b.completion):
        out.append("completion")
    if a.metrics != b.metrics:
        out.append("metrics")
    return out


def stream_counts(res):
    m = res.metrics
    return {"arrivals": m.n_arrivals, "completed": m.n_completed,
            **{f: getattr(res, f) for f in STREAM_COUNTERS},
            "weighted_J": m.weighted_J, "mean_slowdown": m.mean_slowdown,
            "p99_latency_s": m.p99_latency,
            "deadline_misses": m.deadline_misses}


def stream_vs_cpu(np, res, res_c):
    """Card against CPU: the same counters and finished set; the largest
    relative difference of a completion time and of weighted J."""
    fin = np.isfinite(res_c.completion)
    same = (all(getattr(res, f) == getattr(res_c, f)
                for f in STREAM_COUNTERS)
            and res.metrics.n_completed == res_c.metrics.n_completed
            and bool(np.array_equal(np.isfinite(res.completion), fin)))
    d = (np.abs(res.completion[fin] - res_c.completion[fin])
         / np.abs(res_c.completion[fin])) if same and fin.any() else [0.0]
    J, Jc = res.metrics.weighted_J, res_c.metrics.weighted_J
    return {"same_counts_as_cpu": same,
            "completion_rel_vs_cpu": float(np.max(d)),
            "J_rel_vs_cpu": abs(J - Jc) / max(abs(Jc), 1e-300),
            "limit": STREAM_RTOL}


def check_stream_vs_cpu(tag, r):
    check(r["same_counts_as_cpu"]
          and r["completion_rel_vs_cpu"] <= STREAM_RTOL
          and r["J_rel_vs_cpu"] <= STREAM_RTOL,
          f"{tag}: card against CPU {r}")


def stream_inputs():
    """Phase 15's traces, made from their seeds (and the committed log)."""
    from repro_torch.core import sample_arrival_stream
    from repro_torch.core.workloads import load_arrival_log
    return {
        "trace": load_arrival_log(ROOT / STREAM_TRACE),
        "day": sample_arrival_stream(B=B, **DAY_TRACE),
        "broken": sample_arrival_stream(B=B, **BROKEN_TRACE),
        "tenants": [sample_arrival_stream(
            s, horizon=TENANT_HORIZON, rate=0.12, diurnal=0.75,
            period=TENANT_PERIOD, B=B, n_budget_events=2,
            budget_frac=(0.3, 0.8), deadline_slack=50.0)
            for s in TENANT_SEEDS]}


def stream_controller(d, kind="cascade", M=STREAM_M):
    """A controller on ``d`` under s = √θ: the cascade, the default
    streaming policy, or a primary planner that raises."""
    from repro_torch.core import power
    from repro_torch.sched.policies import StreamingSmartFillPolicy
    from repro_torch.serve import StreamCascadePolicy, StreamController

    class Broken(StreamingSmartFillPolicy):
        def plan(self, rem, w, active=None, B=None, warm=True):
            raise FloatingPointError("poisoned solve")

    sp = power(1.0, 0.5, B, device=d)
    policy = {"cascade": lambda: StreamCascadePolicy(sp, B),
              "default": lambda: None,
              "broken": lambda: Broken(sp, B)}[kind]()
    return StreamController(sp, B, max_live=M, policy=policy)


def stream_call(job, d, inputs):
    """Phase 15's call ``job`` on device ``d``."""
    from repro_torch.core import power
    from repro_torch.distributed import fleet_mesh, serve_streams_sharded
    if job in ("trace", "day"):
        return stream_controller(d).run_device(inputs[job])
    if job == "default":
        return stream_controller(d, "default").run(inputs["day"])
    if job == "broken":
        return stream_controller(d, "broken", BROKEN_M).run(
            inputs["broken"])
    return serve_streams_sharded(power(1.0, 0.5, B, device=d),
                                 inputs["tenants"], max_live=STREAM_M,
                                 mesh=fleet_mesh(1, device=d))


STREAM_JOBS = ("trace", "day", "default", "broken", "fleet")


def stream_reference(job):
    """(result, wall s) of phase 15's call ``job`` on the CPU.  On the
    card's host it runs in a worker process, overlapping the card's
    runs; one thread each, so the workers leave the host's other cores
    to the process that drives the card.  The workers are spawned, so
    they import the caller's main module: it must start nothing outside
    its ``if __name__ == "__main__"`` (this script's ``main`` does)."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import torch
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = stream_call(job, torch.device("cpu"), stream_inputs())
    return out, time.perf_counter() - t0


def stream_phase(torch, np, dev):
    """Phase 15 on ``dev``, held against the same calls on the CPU (on a
    CPU ``dev``, a rehearsal: no profile, the CPU references in this
    process).  Returns the phase's kernel launches, all of which must be
    0: the float64 CAP of SmartFill's re-plan takes the closed form,
    never K1–K5."""
    import contextlib
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    reset_all_launches()
    with contextlib.ExitStack() as stack:
        if dev.type == "cuda":
            pool = stack.enter_context(ProcessPoolExecutor(
                max_workers=len(STREAM_JOBS),
                mp_context=multiprocessing.get_context("spawn")))
            refs = {j: pool.submit(stream_reference, j) for j in STREAM_JOBS}
            stack.callback(lambda: [f.cancel() for f in refs.values()])

            def reference(job):
                return refs[job].result()
        else:
            reference = stream_reference
        return _stream_checks(torch, np, dev, reference)


def _stream_checks(torch, np, dev, reference):
    """Phase 15's runs on ``dev`` and their checks; ``reference(job)``
    gives a job's CPU result and wall time."""
    from repro_torch.core.workloads import ArrivalStream
    from repro_torch.serve.stream import _event_arrays

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    inputs = stream_inputs()

    def three_ways(tag, job):
        """The host loop, run_device and run_device in chunks of 17 on
        the card, bit for bit; run_device on the CPU."""
        stream = inputs[job]
        ctl = stream_controller(dev)
        events = int(_event_arrays(stream)[0].size)
        host, wall_h = timed_call(sync, lambda: ctl.run(stream))
        res, wall_d = timed_call(sync, lambda: ctl.run_device(stream))
        reads = ctl.host_reads
        chunked, wall_c = timed_call(
            sync, lambda: ctl.run_device(stream, chunk_events=17))
        res_c, cpu_s = reference(job)
        r = {**stream_counts(res), "events": events, "M": STREAM_M,
             "run_wall_s": wall_h, "run_device_wall_s": wall_d,
             "chunked_wall_s": wall_c, "cpu_wall_s": cpu_s,
             "events_per_s": events / wall_d,
             "host_reads_per_event": reads / events,
             "run_vs_run_device": stream_diff(np, host, res),
             "chunked_vs_whole": stream_diff(np, chunked, res),
             **stream_vs_cpu(np, res, res_c)}
        emit({"phase": tag, **r})
        check(not r["run_vs_run_device"] and not r["chunked_vs_whole"],
              f"{tag}: run, run_device and the chunked run_device differ "
              f"on the card: {r}")
        check_stream_vs_cpu(tag, r)
        return r, ctl

    # ---- a. the committed trace ------------------------------------------
    r, _ = three_ways("stream_trace", "trace")
    check((r["arrivals"], r["completed"]) == (141, 139),
          f"stream_trace: the reference completes 139 of 141 arrivals: {r}")

    # ---- b. the quick day trace, with a profile of its first events ------
    r, ctl = three_ways("stream_day", "day")
    check(r["completed"] == r["arrivals"],
          f"stream_day: an arrival did not complete: {r}")
    if on_card:
        day = inputs["day"]
        k = PROFILE_EVENTS - 1           # arrivals; the end is the last event
        cut = day.budget_times < day.t[k]
        head = ArrivalStream(
            t=day.t[:k], x=day.x[:k], w=day.w[:k], deadline=day.deadline[:k],
            horizon=float(day.t[k]), budget_times=day.budget_times[cut],
            budget_values=day.budget_values[cut])
        replans = ctl.run_device(head).replans
        wall_p, busy, n_dev, n_launch = device_profile(
            torch, lambda: (ctl.run_device(head), sync()))
        events = int(_event_arrays(head)[0].size)
        p = {"events": events, "replans": replans, "profiled_wall_s": wall_p,
             "device_busy_s": busy, "busy_share": busy / wall_p,
             "device_kernels": n_dev, "kernel_launches": n_launch,
             "kernels_per_replan": n_launch / replans,
             "kernels_per_event": n_launch / events}
        emit({"phase": "stream_day_profile", **p})
        check(busy > 0, f"stream_day_profile: no device work {p}")

    # ---- c. the default streaming policy on (b)'s trace -------------------
    res, wall = timed_call(sync, lambda: stream_call("default", dev, inputs))
    res_c, cpu_s = reference("default")
    r = {**stream_counts(res), "policy": "StreamingSmartFillPolicy",
         "wall_s": wall, "cpu_wall_s": cpu_s,
         **stream_vs_cpu(np, res, res_c)}
    emit({"phase": "stream_default_policy", **r})
    check_stream_vs_cpu("stream_default_policy", r)

    # ---- d. a primary planner that raises: every replan on the ladder ----
    res, wall = timed_call(sync, lambda: stream_call("broken", dev, inputs))
    res_c, _ = reference("broken")
    r = {**stream_counts(res), "M": BROKEN_M, "wall_s": wall,
         **stream_vs_cpu(np, res, res_c)}
    emit({"phase": "stream_broken_primary", **r})
    check(r["degraded_windows"] == r["replans"] > 0
          and r["completed"] == res.metrics.n_admitted,
          f"stream_broken_primary: not every replan on the ladder, or an "
          f"admitted job unfinished: {r}")
    check_stream_vs_cpu("stream_broken_primary", r)

    # ---- e. the fleet's stream service at D = 1 ----------------------------
    tenants = inputs["tenants"]
    fleet, wall = timed_call(sync, lambda: stream_call("fleet", dev, inputs))
    solos, wall_s = timed_call(sync, lambda: [
        stream_controller(dev).run_device(t) for t in tenants])
    fleet_c, cpu_s = reference("fleet")
    events = sum(int(_event_arrays(t)[0].size) for t in tenants)
    view = ("backlog", "unfinished_work", "suggested_budget_share",
            "deadline_misses", "mean_slowdown", "p99_latency")
    r = {"tenants": len(tenants), "D": 1, "events": events,
         "arrivals": [len(t) for t in tenants],
         "completed": [x.metrics.n_completed for x in fleet.results],
         "replans": [x.replans for x in fleet.results],
         "wall_s": wall, "solo_wall_s": wall_s, "cpu_wall_s": cpu_s,
         "events_per_s": events / wall,
         "vs_solo": [stream_diff(np, a, b)
                     for a, b in zip(fleet.results, solos)],
         "view_vs_cpu": [f for f in view if not np.allclose(
             getattr(fleet, f), getattr(fleet_c, f), rtol=STREAM_RTOL,
             atol=0.0)],
         "suggested_budget_share": fleet.suggested_budget_share.tolist()}
    emit({"phase": "fleet_streams", **r})
    check(not any(r["vs_solo"]),
          f"fleet_streams: a tenant differs from its solo run_device: {r}")
    check(not r["view_vs_cpu"],
          f"fleet_streams: the admission view differs from the CPU's: {r}")

    launches = all_launches()
    emit({"phase": "stream_launches", "launches": launches,
          "note": "no K1-K5 launch: the float64 CAP of the re-plan takes "
                  "the closed form"})
    check(not any(launches.values()),
          f"a kernel was launched in the streaming phase: {launches}")
    return launches


# ---- 16(a). the cluster scheduler, float64 -----------------------------------
# ``sched/cluster.py`` on the card, each call held to the port's CPU run of
# the same call: examples/batched_planning.py §2's eight fleets;
# benchmarks/cluster_sim.py::bench_cluster's instance (12 jobs on 256 GPUs
# under job_speedup's analytic roofline: the repo holds no dry-run JSON)
# through the cost-free device path (SmartFill ≤ heSRPT), the host loop
# with a 30 s reallocation cost and 2-chip merging, and integer chips;
# the roofline speedups of CLUSTER_POD_JOBS of the ten configs (all ten
# until phase 18 needed the room: the pod's device path took 58.7 s and
# its host loop 28.5 s at ten) as the jobs of one 256-GPU pod (the plan,
# and the device and host paths against each other at the reference's
# 1e-5, tests/sched/test_cluster.py:213-221); and 256 fleets
# under a one-card fleet mesh, bit for bit to the call without one.  The
# float64 CAP takes the closed form: no K1–K5 launch.
CLUSTER_GPUS, CLUSTER_M, CLUSTER_FLEETS = 256.0, 12, 256
CLUSTER_POD_JOBS = 6       # the first six configs in name order
CLUSTER_RTOL = 1e-9        # card vs CPU: J; Σθ = B
# card vs CPU: allocations (over B) and event times (relative).  Off the
# pure-power path SmartFill's schedule is determined only to ~1e-7 (μ*
# sits at a flat minimum; J to ~1e-16): the §2 fleets have read 6.1e-9
# of B between card and CPU on the H100 (PERF.md §6).
CLUSTER_THETA_RTOL = 1e-7
CLUSTER_PATHS_RTOL = 1e-5  # the pod's device path vs its host loop


CLUSTER_SIMS = {"cost_free": {},
                "realloc30_merge2": {"realloc_cost_s": 30.0, "min_delta": 2.0},
                "integer_chips": {"integer_chips": True}}
CLUSTER_JOBS = ("fleets", *CLUSTER_SIMS, "pod_plan", "pod_ref",
                "pod_device", "pod_host", "many_fleets")


def batched_planning_fleets(np, Job):
    """examples/batched_planning.py §2's eight fleets: its generator after
    §1's draws (N = 256 instances of 2..16 jobs)."""
    rng = np.random.default_rng(0)
    ms = rng.integers(2, 16 + 1, 256)
    for n in range(256):
        rng.uniform(0.5, 20.0, ms[n])
    fleets = []
    for _ in range(8):
        k = int(rng.integers(2, 7))
        sizes = np.sort(rng.uniform(50.0, 500.0, k))[::-1]
        fleets.append([Job(name=f"j{i}", size=float(s), weight=float(1.0 / s))
                       for i, s in enumerate(sizes)])
    return fleets


def cluster_call(job, d):
    """Phase 16(a)'s call ``job`` on device ``d`` (instance built there),
    its result in host values."""
    import numpy as np
    from repro_torch.configs import get_config, list_archs
    from repro_torch.core import log_speedup, smartfill_hetero, stack_speedups
    from repro_torch.core.speedup import host_call
    from repro_torch.sched.cluster import ClusterScheduler, Job
    from repro_torch.sched.speedup_models import job_speedup

    if job in ("fleets", "many_fleets"):
        cs = ClusterScheduler(log_speedup(1.0, 1.0, B, device=d), B)
        if job == "fleets":
            return cs.current_allocations_fleets(
                batched_planning_fleets(np, Job))
        rng = np.random.default_rng(3)
        many = []
        for n in range(CLUSTER_FLEETS):
            sz = np.sort(rng.uniform(50.0, 500.0, int(rng.integers(2, 17))))
            many.append([Job(name=f"f{n}j{i}", size=float(s),
                             weight=float(1.0 / s))
                         for i, s in enumerate(sz[::-1])])
        return cs.current_allocations_fleets(many)
    if job in CLUSTER_SIMS:
        # benchmarks/cluster_sim.py::bench_cluster's instance
        sp = job_speedup(step_flops=6 * 7e9 * 1e6, grad_bytes=2 * 7e9,
                         tokens_per_step=1e6, B=CLUSTER_GPUS, device=d)
        rng = np.random.default_rng(0)
        sizes = np.sort(rng.uniform(1.0, 20.0, CLUSTER_M))[::-1] * 1e9
        jobs = [Job(name=f"job{i}", size=float(sizes[i]),
                    weight=float(1.0 / sizes[i])) for i in range(CLUSTER_M)]
        return ClusterScheduler(sp, CLUSTER_GPUS,
                                **CLUSTER_SIMS[job]).simulate(jobs)
    # the roofline speedups of CLUSTER_POD_JOBS configs on one 256-GPU pod
    names = sorted(list_archs())[:CLUSTER_POD_JOBS]
    members = [job_speedup(
        step_flops=6.0 * get_config(a).active_param_count() * POD_TOKENS,
        grad_bytes=2.0 * get_config(a).param_count(),
        tokens_per_step=POD_TOKENS, B=POD_GPUS, device=d) for a in names]
    x = np.random.default_rng(0).uniform(2, 15, len(names)) * 1e9
    w = np.array([float(host_call(m, "s", POD_GPUS)) for m in members]) / x
    jobs = [Job(name=a, size=float(x[i]), weight=float(w[i]),
                speedup=members[i]) for i, a in enumerate(names)]
    cs = ClusterScheduler(members[0], POD_GPUS)
    if job == "pod_plan":
        order, plan = cs.plan(jobs)
        return [int(i) for i in order], plan.J, plan.J_linear
    if job == "pod_ref":            # the reference test's check of the plan
        ref = smartfill_hetero(stack_speedups(members, B=POD_GPUS), x, w,
                               B=POD_GPUS, exchange_passes=0)
        return [int(i) for i in ref.order], ref.J
    if job == "pod_device":
        return cs.simulate(jobs)
    return cs.simulate_host(jobs)


def cluster_reference(job):
    """(result, wall s) of phase 16(a)'s call ``job`` on the CPU; on the
    card's host in a spawned worker of one thread (as phase 15's)."""
    if str(SRC) not in sys.path:
        sys.path.insert(0, str(SRC))
    import torch
    torch.set_num_threads(1)
    t0 = time.perf_counter()
    out = cluster_call(job, torch.device("cpu"))
    return out, time.perf_counter() - t0


def schedule_of(np, events):
    """The events at which the allocation changes.  The host loop marks a
    job done once its remaining size is ≤ 1e-9; a completion that leaves
    a rounding residue above that (sizes here are ~1e9–2e10 tokens) is
    finished by one more event a moment later that keeps the allocation
    (a merge), and which completion leaves one depends on the last bits."""
    out = []
    for t, th in events:
        if not out or not np.array_equal(th, out[-1][1]):
            out.append((t, th))
    return out


def cluster_runs_close(np, run, ref, B_):
    """Readings of two (events, J) runs: event counts, J, and the times
    and allocations (over B) of their schedules (``schedule_of``)."""
    (ev, J), (ev_r, J_r) = run, ref
    r = {"events": len(ev), "cpu_events": len(ev_r), "J": J,
         "dJ": abs(J - J_r) / abs(J_r)}
    ev, ev_r = schedule_of(np, ev), schedule_of(np, ev_r)
    r.update(changes=len(ev), cpu_changes=len(ev_r),
             ghost_events=r["events"] - len(ev),
             cpu_ghost_events=r["cpu_events"] - len(ev_r))
    if len(ev) == len(ev_r):
        r["dt"] = max((abs(t - tr) / max(1.0, abs(tr))
                       for (t, _), (tr, _) in zip(ev, ev_r)), default=0.0)
        r["dtheta"] = max((float(np.abs(th - thr).max()) / B_
                           for (_, th), (_, thr) in zip(ev, ev_r)),
                          default=0.0)
    return r


def cluster_ok(r):
    """The same schedule, card against CPU: as many allocation changes,
    at the same times, to the same allocations, and J to 1e-9.  The raw
    event counts may differ by ghost events (``schedule_of``): on the
    H100 the integer-chip run has made 12 events on the card and 13 on
    the CPU over the same 12 changes, which is recorded, not held."""
    return (r["dJ"] <= CLUSTER_RTOL and r["changes"] == r["cpu_changes"]
            and r["dt"] <= CLUSTER_THETA_RTOL
            and r["dtheta"] <= CLUSTER_THETA_RTOL)


def cluster_phase(torch, np, dev):
    """Phase 16(a): the cluster scheduler on ``dev`` in float64, each call
    held to the same call on the CPU (on the card's host in worker
    processes beside the card's runs; on a CPU ``dev``, a rehearsal, in
    this process).  Returns the phase's kernel launches, all of which
    must be 0."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    reset_all_launches()
    with contextlib.ExitStack() as stack:
        if dev.type == "cuda":
            pool = stack.enter_context(ProcessPoolExecutor(
                max_workers=4,
                mp_context=multiprocessing.get_context("spawn")))
            refs = {j: pool.submit(cluster_reference, j)
                    for j in CLUSTER_JOBS}
            stack.callback(lambda: [f.cancel() for f in refs.values()])

            def reference(job):
                return refs[job].result()
        else:
            reference = cluster_reference
        return _cluster_checks(torch, np, dev, reference)


def _cluster_checks(torch, np, dev, reference):
    """Phase 16(a)'s runs on ``dev`` and their checks; ``reference(job)``
    gives a job's CPU result and wall time."""
    from repro_torch.core import fit_power, simulate_policy
    from repro_torch.core.speedup import host_call
    from repro_torch.distributed import fleet_mesh
    from repro_torch.sched import HeSRPTPolicy
    from repro_torch.sched.speedup_models import job_speedup

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def run(job):
        return timed_call(sync, lambda: cluster_call(job, dev))

    # examples/batched_planning.py §2
    al, wall = run("fleets")
    al_c, cpu_s = reference("fleets")
    r = {"fleets": len(al), "wall_s": wall, "cpu_wall_s": cpu_s,
         "sum_vs_B": max(abs(a.sum() - B) / B for a in al),
         "card_vs_cpu": max(float(np.abs(a - c).max()) / B
                            for a, c in zip(al, al_c)),
         "fleet0": al[0].tolist()}
    emit({"phase": "cluster_batched_planning", **r})
    check(r["sum_vs_B"] <= CLUSTER_RTOL
          and r["card_vs_cpu"] <= CLUSTER_THETA_RTOL, f"cluster fleets: {r}")

    # benchmarks/cluster_sim.py::bench_cluster's instance, three ways
    got = {}
    for name in CLUSTER_SIMS:
        res, wall = run(name)
        res_c, cpu_s = reference(name)
        r = cluster_runs_close(np, res, res_c, CLUSTER_GPUS)
        r.update(path=res.path, status=res.status, wall_s=wall,
                 cpu_wall_s=cpu_s)
        got[name] = r
        emit({"phase": f"cluster_sim_{name}", **r})
        check(cluster_ok(r) and res.ok, f"cluster {name} card vs CPU: {r}")
    sp_c = job_speedup(step_flops=6 * 7e9 * 1e6, grad_bytes=2 * 7e9,
                       tokens_per_step=1e6, B=CLUSTER_GPUS, device="cpu")
    a_fit, p_fit = fit_power(
        lambda t: float(host_call(sp_c, "s", max(t, 1e-6))), CLUSTER_GPUS)
    rng = np.random.default_rng(0)
    sizes = np.sort(rng.uniform(1.0, 20.0, CLUSTER_M))[::-1] * 1e9
    sp = job_speedup(step_flops=6 * 7e9 * 1e6, grad_bytes=2 * 7e9,
                     tokens_per_step=1e6, B=CLUSTER_GPUS, device=dev)
    he, _ = timed_call(sync, lambda: simulate_policy(
        sp, sizes, 1.0 / sizes, HeSRPTPolicy(p=p_fit, B=CLUSTER_GPUS),
        B=CLUSTER_GPUS))
    J_sf = got["cost_free"]["J"]
    r = {"smartfill_J": J_sf, "hesrpt_J": he.J, "fit": [a_fit, p_fit],
         "smartfill_gain": (he.J - J_sf) / he.J,
         "realloc_over_free": got["realloc30_merge2"]["J"] / J_sf - 1.0,
         "integer_over_free": got["integer_chips"]["J"] / J_sf - 1.0,
         "paths": [got[k]["path"] for k in got]}
    emit({"phase": "cluster_bench", **r})
    check(r["paths"] == ["device", "host", "host"],
          f"cluster simulate took the wrong paths: {r['paths']}")
    check(J_sf <= he.J * (1 + 1e-9), f"cluster: SmartFill J above heSRPT's: "
                                     f"{r}")

    # the roofline speedups of CLUSTER_POD_JOBS configs on one pod
    (order, J, J_lin), wall = run("pod_plan")
    (order_c, J_c, _), cpu_s = reference("pod_plan")
    (ref_order, ref_J), _ = reference("pod_ref")
    r = {"jobs": len(order), "plan_wall_s": wall, "cpu_plan_wall_s": cpu_s,
         "J": J, "order": order, "card_vs_cpu": abs(J - J_c) / J_c,
         "vs_smartfill_hetero_cpu": abs(J - ref_J) / ref_J,
         "J_vs_J_linear": abs(J - J_lin) / J}
    dev_run, wall = run("pod_device")
    dev_run_c, cpu_s = reference("pod_device")
    r.update(device_path=dev_run.path, device_wall_s=wall,
             cpu_device_wall_s=cpu_s,
             device=cluster_runs_close(np, dev_run, dev_run_c, POD_GPUS))
    host_run, wall = run("pod_host")
    host_run_c, cpu_s = reference("pod_host")
    r.update(host_wall_s=wall, cpu_host_wall_s=cpu_s,
             host=cluster_runs_close(np, host_run, host_run_c, POD_GPUS),
             device_vs_host=abs(dev_run.J - host_run[1]) / host_run[1])
    emit({"phase": "cluster_pod", **r})
    check(order == order_c == ref_order and r["card_vs_cpu"] <= CLUSTER_RTOL
          and r["vs_smartfill_hetero_cpu"] <= 1e-6, f"cluster pod plan: {r}")
    check(dev_run.path == "device" and dev_run.ok, f"cluster pod: {r}")
    check(cluster_ok(r["device"]) and cluster_ok(r["host"]),
          f"cluster pod card vs CPU: {r}")
    check(r["device_vs_host"] <= CLUSTER_PATHS_RTOL,
          f"cluster pod device path vs host loop: {r}")

    # 256 fleets, without and under a one-card fleet mesh
    plain, wall = run("many_fleets")
    with fleet_mesh(1, device=dev):
        meshed, mesh_wall = run("many_fleets")
    plain_c, cpu_s = reference("many_fleets")
    r = {"fleets": CLUSTER_FLEETS, "wall_s": wall, "mesh_wall_s": mesh_wall,
         "cpu_wall_s": cpu_s,
         "bit_for_bit": all(np.array_equal(a, b)
                            for a, b in zip(plain, meshed)),
         "card_vs_cpu": max(float(np.abs(a - c).max()) / B
                            for a, c in zip(plain, plain_c))}
    emit({"phase": "cluster_fleet_mesh", **r})
    check(r["bit_for_bit"], "cluster fleets: the mesh changed the bits")
    check(r["card_vs_cpu"] <= CLUSTER_THETA_RTOL,
          f"cluster fleets on a mesh: {r}")
    launches = all_launches()
    check(not any(launches.values()),
          f"a kernel was launched in the cluster phase: {launches}")
    return launches


# ---- 16(b). falcon-mamba-7b at full width through K4 --------------------------
# MAMBA_LAYERS of its 64 Mamba blocks, d 4096, d_inner 8192, N 16, bf16,
# seed-0 weights made on the card.  Each layer's prefill scans 4096
# tokens in chunks of scan_chunk = 256: one K4 call a chunk on (2, 256,
# 8192·16) f32, the carry folded into the chunk's first step, so a
# prefill launches K4 exactly 16 × 16 = 256 times and K5 never.
def chunk_pair(torch, cap):
    """The first Mamba layer's first two chunks as wave 0 scanned them:
    (a0, b0, h0), (a1, b1, h1), each a and b (B, c, di, N) f32 before the
    fold, h the state folded in."""
    (a0, b0, h0), _ = cap["chunks"][0]
    (a1, b1, h1), _ = cap["chunks"][1]
    return (a0, b0, h0), (a1, b1, h1)


def mamba_scan_phase(torch, cap, launches):
    """Phase 16(b), continued: K4 against its plain version across the
    boundary of the first layer's first two chunks (two K4 calls, the
    carry folded into the second, against one plain scan over both), in
    f32 RMS units; the carry dropped between the chunks must read over the
    limit.  Then K4's times at the chunk shape and the wrapper's own
    allocations a launch.  Returns K4's Mamba-path record."""
    from repro_torch.kernels.linear_scan import kernel as sk
    from repro_torch.kernels.linear_scan import ops as so
    from repro_torch.kernels.linear_scan.ref import linear_scan_ref
    from repro_torch.models.scan_ops import _scan_folded

    (a0, b0, h0), (a1, b1, h1) = chunk_pair(torch, cap)
    Bsz, c = a0.shape[:2]
    D = a0[0, 0].numel()

    def flat(t):
        return t.reshape(Bsz, -1, D)

    A = torch.cat([flat(a0), flat(a1)], 1)
    Bf = torch.cat([flat(b0), flat(b1)], 1)
    Bf[:, 0] += A[:, 0] * h0.reshape(Bsz, D)
    plain = linear_scan_ref(A, Bf)
    k0 = _scan_folded(a0, b0.clone(), h0)
    k1 = _scan_folded(a1, b1.clone(), k0[:, -1])
    sound = torch.cat([flat(k0), flat(k1)], 1)
    dropped = torch.cat([flat(k0), flat(_scan_folded(
        a1, b1.clone(), torch.zeros_like(h0)))], 1)
    r = {"shape": [Bsz, 2 * c, D], "f32_rms_units": rms_err(sound, plain),
         "f32_max_abs": float((sound - plain).abs().max()),
         "fault_carry_dropped": rms_err(dropped, plain),
         "h0_zero": not bool(h0.any()),
         "carry_as_served": bool(torch.equal(h1, k0[:, -1])),
         "limit": K4_F32_LIMIT}
    torch.cuda.synchronize()
    emit({"phase": "mamba_kernels", **r})
    check(r["h0_zero"], "the first layer's first chunk did not start at 0")
    check(r["f32_rms_units"] <= K4_F32_LIMIT,
          f"K4 across the chunk boundary vs plain: {r['f32_rms_units']:.3e}")
    check(r["fault_carry_dropped"] > K4_F32_LIMIT,
          f"K4: the dropped carry reads {r['fault_carry_dropped']:.3e}, "
          f"within {K4_F32_LIMIT}")
    del A, Bf, plain, sound, dropped, k0, k1

    a = flat(a0).contiguous()
    b = flat(b0).contiguous()
    rec = kernel_record(torch, "linear_scan", CU_K4, TPU_K4,
                        lambda impl: so.linear_scan_op(a, b, impl=impl), 3,
                        scan_bound(a), None, launches["linear_scan"],
                        r["f32_max_abs"], phase="mamba_time")
    geo = sk.scan_geometry(*a.shape)
    rec["wrapper_alloc_ms"] = timed(torch, lambda: (
        torch.zeros(geo.flag_ints, dtype=torch.int32, device=a.device),
        torch.empty(geo.carry_floats, dtype=torch.float32, device=a.device)))
    rec["shape"] = list(a.shape)
    emit({"phase": "mamba_wrapper", "shape": list(a.shape),
          "flag_ints": geo.flag_ints, "carry_floats": geo.carry_floats,
          "alloc_ms": rec["wrapper_alloc_ms"], "op_ms": rec["ms"],
          "kernel_device_ms": rec["kernel_device_ms"]})
    return {k: rec[k] for k in ("launches", "max_abs_err", "ms", "plain_ms",
                                "bound_ms", "bound_by", "kernel_device_ms",
                                "wrapper_alloc_ms", "shape")}


def mamba_phase(torch, np, dev):
    """Phase 16(b): falcon-mamba-7b at ``MAMBA_LAYERS`` layers serves
    ``MAMBA_WAVES`` waves through
    ``serve_phase``; K4 across a chunk boundary and its times; wave 0 end
    to end through the plain scan.  Returns K4's Mamba-path record."""
    from repro_torch.configs import get_config
    cfg = get_config(MAMBA_ARCH).replace(n_layers=MAMBA_LAYERS)
    per_prefill = cfg.n_layers * -(-PROMPT // cfg.scan_chunk)
    model, batch0, out0, cap, launches = serve_phase(
        torch, np, dev, arch=MAMBA_ARCH, cfg=cfg, waves=MAMBA_WAVES,
        expect={"flash_attention": (0, True),
                "linear_scan": (per_prefill, True)},
        prefix="mamba")
    with torch.inference_mode():
        rec = mamba_scan_phase(torch, cap, launches)
        end_to_end_phase(torch, model, batch0, out0, cap, arch=MAMBA_ARCH,
                         prefix="mamba", floor=True)
    return rec


# ---- phase 17: MoE, the VLM prefix, the encoder–decoder --------------------
def k5_path_check(torch, label, qkv, kw):
    """K5 against its plain version on one call's inputs of a phase-17
    path, as phase 8 reads it: f32 (the inputs cast up) in RMS units,
    bf16 relative and in RMS units of the f32 plain output, and planted
    faults — the last kv tile dropped, causal flipped, the window one
    wider where there is one — which must read over the f32 limit; the
    causal flip must also read over the bf16 limit through the bf16
    kernel.  Prints ``<label>_kernels``; returns the readings, with each
    dtype's relative RMS distance (``perturbed_attention``'s scale)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import attention_ref

    q, k, v = qkv
    kw = {"causal": kw.get("causal", True), "window": kw.get("window"),
          "cap": kw.get("cap")}
    q32, k32, v32 = q.float(), k.float(), v.float()
    plain = attention_ref(q32, k32, v32, **kw)
    out32 = fk.flash_attention(q32, k32, v32, **kw)
    out16 = fk.flash_attention(q, k, v, **kw)
    plain16 = attention_ref(q, k, v, **kw)

    def causal_flip(q_, k_, v_, **w):
        return fk.flash_attention(q_, k_, v_, **dict(w, causal=not w["causal"]))

    r = {"q": list(q.shape), "kv": list(k.shape), **kw,
         "f32_rms_units": rms_err(out32, plain),
         "f32_rel_rms": rel_rms(out32, plain),
         "bf16_rel": rel_err(out16, plain16),
         "bf16_rel_rms": rel_rms(out16, plain16),
         "bf16_max_abs": float((out16.float() - plain16.float()).abs().max()),
         "bf16_rms_units": rms_err(out16, plain),
         "plain_bf16_rms_units": rms_err(plain16, plain)}
    faults = {"dropped_last_kv_tile": attn_dropped_last_kv_tile,
              "causal_flip": causal_flip}
    if kw["window"]:
        faults["window_plus_1"] = attn_window_plus_1
    for dt, ins in (("", (q32, k32, v32)), ("bf16_", (q, k, v))):
        for name, fault in faults.items():
            r[f"{dt}fault_{name}"] = rms_err(fault(*ins, **kw), plain)
    torch.cuda.synchronize()
    emit({"phase": f"{label}_kernels",
          "limits": {"f32": K5_F32_LIMIT, "bf16": BF16_LIMIT,
                     "bf16_rms": K5_BF16_RMS_LIMIT}, **r})
    check(r["f32_rms_units"] <= K5_F32_LIMIT,
          f"{label}: K5 vs plain in f32: {r['f32_rms_units']:.3e}")
    check(r["bf16_rel"] <= BF16_LIMIT,
          f"{label}: K5 vs plain in bf16: {r['bf16_rel']:.3e}")
    check(r["bf16_rms_units"] <= K5_BF16_RMS_LIMIT,
          f"{label}: K5 bf16 vs f32 plain: {r['bf16_rms_units']:.3e}")
    for name in faults:
        check(r[f"fault_{name}"] > K5_F32_LIMIT,
              f"{label}: K5's planted fault {name} reads "
              f"{r[f'fault_{name}']:.3e}")
    check(r["bf16_fault_causal_flip"] > K5_BF16_RMS_LIMIT,
          f"{label}: K5's causal flip in bf16 reads "
          f"{r['bf16_fault_causal_flip']:.3e}")
    return r


def k5_time(torch, label, qkv, kw, launches, err):
    """K5's times at a phase-17 shape (``kernel_record``): its bound from
    the (q, k) pairs the mask leaves (S = T when causal), SDPA on the same
    inputs as the yardstick."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as fo

    q, k, v = qkv
    kw = {"causal": kw.get("causal", True), "window": None,
          "cap": kw.get("cap")}
    B_, S, H, hd = q.shape
    T, K_ = k.shape[1], k.shape[2]
    check(kw["cap"] is None and (not kw["causal"] or S == T),
          f"{label}: K5's yardstick takes no softcap, and S = T if causal")
    pairs = S * (S + 1) // 2 if kw["causal"] else S * T
    k5_ops = 4 * B_ * H * hd * pairs
    k5_bytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=kw["causal"], scale=1.0,
            enable_gqa=H != K_)

    lib_err = rel_err(sdpa().transpose(1, 2), fo.attention_ref(q, k, v, **kw))
    rec = kernel_record(torch, "flash_attention", CU_K5, TPU_K5,
                        lambda impl: fo.flash_attention_op(q, k, v, impl=impl,
                                                           **kw),
                        3, bound(k5_bytes, k5_ops, BF16_TC_OPS),
                        timed(torch, sdpa), launches, err,
                        phase=f"{label}_time")
    rec["sdpa_vs_plain_bf16_rel"] = lib_err
    rec["shape"] = {"q": list(q.shape), "kv": list(k.shape), **kw}
    return rec


def route_stats(cfg, routes):
    """Wave 0's prefill routes a layer: tokens' choices dropped by
    capacity and the largest count of choices of one expert in one group
    (against the capacity C)."""
    from repro_torch.models.moe import capacity, slot_positions
    dropped, max_load = [], []
    for t in routes[:cfg.n_layers]:
        N, k = t.shape
        G = min(cfg.moe_group_size, N)
        C = capacity(cfg, G)
        oh, pos = slot_positions(t.long().view(-1, G, k), cfg.n_experts)
        dropped.append(int((pos >= C).sum()))
        max_load.append(int(oh.sum(dim=(1, 2)).max()))
    return {"group": G, "capacity": C, "choices": N * k,
            "dropped": dropped, "max_load": max_load}


def moe_serve_phase(torch, np, dev, arch, cfg, waves, prefix):
    """Phase 17(a)/(b): a MoE through ``serve_phase`` (dispatch, K5 once
    a layer), its routes, and K5 against its plain version on layer 0's
    q/k/v.  Returns (model, wave 0's batch and tokens, captures,
    launches, the K5 readings)."""
    model, batch0, out0, cap, launches = serve_phase(
        torch, np, dev, arch=arch, cfg=cfg, waves=waves, prefix=prefix,
        expect={"flash_attention": (cfg.n_layers, True),
                "linear_scan": (0, True)})
    emit({"phase": f"{prefix}_routes", "moe_impl": cfg.moe_impl,
          **route_stats(cfg, cap["routes"])})
    with torch.inference_mode():
        r = k5_path_check(torch, prefix, *cap["qkv"][0])
    return model, batch0, out0, cap, launches, r


def new_paths_phase(torch, np, dev):
    """Phase 17: qwen2-moe-a2.7b (full), dbrx-132b (DBRX_LAYERS),
    internvl2-1b and seamless-m4t-medium serve at full width in bf16,
    each freed before the next.  Returns K5's launches on each path and
    its record at qwen2-moe's shape."""
    from repro_torch.configs import get_config

    launches = {}
    # (a) the MoE at full depth, dispatch as configured
    cfg = get_config(MOE_ARCH)
    model, batch0, out0, cap, n, r = moe_serve_phase(
        torch, np, dev, MOE_ARCH, cfg, MOE_WAVES, "moe")
    launches["qwen2-moe-a2.7b"] = n["flash_attention"]
    with torch.inference_mode():
        rec = k5_time(torch, "moe", *cap["qkv"][0], n["flash_attention"],
                      r["bf16_max_abs"])
        end_to_end_phase(torch, model, batch0, out0, cap, arch=MOE_ARCH,
                         prefix="moe", f32_layers=MOE_F32_LAYERS,
                         perturb={"bf16": r["bf16_rel_rms"],
                                  "f32": r["f32_rel_rms"]})
    del model, cap
    torch.cuda.empty_cache()

    # (b) dbrx at DBRX_LAYERS layers: no shared experts, E = 16, GQA 48:8
    cfg = get_config(DBRX_ARCH).replace(n_layers=DBRX_LAYERS)
    model, _, _, cap, n, _ = moe_serve_phase(
        torch, np, dev, DBRX_ARCH, cfg, 1, "dbrx")
    launches["dbrx-132b"] = n["flash_attention"]
    del model, cap
    torch.cuda.empty_cache()

    # (c) the VLM: 256 patches before 3840 tokens, GQA 7:1 at hd 64
    cfg = get_config(VLM_ARCH)
    model, batch0, out0, cap, n = serve_phase(
        torch, np, dev, arch=VLM_ARCH, waves=1, prefix="vlm",
        expect={"flash_attention": (cfg.n_layers, True),
                "linear_scan": (0, True)})
    launches["internvl2-1b"] = n["flash_attention"]
    with torch.inference_mode():
        r = k5_path_check(torch, "vlm", *cap["qkv"][0])
        end_to_end_phase(torch, model, batch0, out0, cap, arch=VLM_ARCH,
                         prefix="vlm", perturb={"bf16": r["bf16_rel_rms"],
                                                "f32": r["f32_rel_rms"]})
    del model, cap
    torch.cuda.empty_cache()

    # (d) the encoder–decoder: 12 non-causal encoder calls over the
    # frames, then 12 causal decoder calls and 12 cross calls
    cfg = get_config(ENCDEC_ARCH)
    L, Le = cfg.n_layers, cfg.n_enc_layers
    model, batch0, out0, cap, n = serve_phase(
        torch, np, dev, arch=ENCDEC_ARCH, waves=1, prefix="encdec",
        expect={"flash_attention": (Le + 2 * L, True),
                "linear_scan": (0, True)})
    launches["seamless-m4t-medium"] = n["flash_attention"]
    kinds = {}
    for sig in cap["qkv_calls"]:
        kinds[str(sig)] = kinds.get(str(sig), 0) + 1
    want = {str((False, ENCDEC_FRAMES, ENCDEC_FRAMES)): Le,
            str((True, ENCDEC_PROMPT, ENCDEC_PROMPT)): L,
            str((False, ENCDEC_PROMPT, ENCDEC_FRAMES)): L}
    emit({"phase": "encdec_calls", "calls": kinds, "expected": want})
    check(kinds == want, f"seamless's K5 calls (causal, S, T): {kinds}")
    with torch.inference_mode():
        r_enc = k5_path_check(torch, "encdec_encoder", *cap["qkv"][0])
        r_x = k5_path_check(torch, "encdec_cross", *cap["qkv"][Le + 1])
        end_to_end_phase(
            torch, model, batch0, out0, cap, arch=ENCDEC_ARCH,
            prefix="encdec",
            perturb={dt: max(r_enc[f"{dt}_rel_rms"], r_x[f"{dt}_rel_rms"])
                     for dt in ("bf16", "f32")})
    del model, cap
    torch.cuda.empty_cache()
    return launches, rec


# ---- phase 18: training llama3.2-1b at full width --------------------------
# The train step (``train/loop.py``) on the full config: 16 layers, d 2048,
# 32:8 heads of 64, vocab 128256 tied, bf16 compute on f32 masters, remat
# "full", the launcher's AdamW (lr 3e-3, 20 warm-up steps); TRAIN_STEPS
# steps of SyntheticTokens at TRAIN_BATCH × TRAIN_SEQ in TRAIN_MICRO
# micro-batches (the reference's train_4k global batch of 256 cut to 8).
# Under remat "full" K5's forward runs twice a layer and micro-batch (the
# checkpoint recomputes it in the backward pass), its backward once.
TRAIN_ARCH = "llama3.2-1b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO = 8, 8, 4096, 2
TRAIN_OPT = {"lr": 3e-3, "warmup_steps": 20}
CU_K5_BWD = ("src/repro_torch/kernels/flash_attention/csrc/"
             "flash_attention_bwd.cu")
# K5's backward replaces no Pallas kernel: the JAX package trains through
# autodiff of this function
XLA_ATTN = "src/repro/models/attention.py:61"
# K5's backward against autograd through its plain version: f32 in units
# of the plain gradient's RMS (max |Δ|; sound 4e-6–3.9e-4 in the first
# H100 runs, the most at the path shape, where the first keys' dk and dv
# sum 4096 rows and stand ~50 RMS above the rest),
# bf16 relative as phase 8 reads the forward (max |Δ| / (|plain| + RMS)),
# and bf16 as the RMS of the difference over the RMS of the f32 plain
# gradient of the same bf16 inputs (sound ~4e-3; the plain version's own
# bf16 rounding reads ~1.7e-3).  The max-in-RMS-units reading is not held
# in bf16: with the softcap's scores of std 60 the plain version's own
# bf16 rounding of its largest gradient reads 0.23 there.  The planted
# faults of the backward (dK/dV of one head of each GQA group, the causal
# mask flipped, the softcap dropped, the window one wider) must read over
# the f32 limit in f32 and, but for the window, over the bf16 RMS limit
# in bf16.  A fault whose gradients overflow (the softcap dropped, the
# causal mask flipped under a softcap: exp(s − L) past f32) reads NaN,
# which counts as over the limit.
BWD_F32_LIMIT = 2e-3
BWD_BF16_LIMIT = 1e-1
BWD_BF16_RMS_LIMIT = 2e-2
# (c): one step at B 1 × 4096 through the kernels and through the plain
# versions; the floor is the plain run against itself with noise of (a)'s
# relative readings, the largest over TRAIN_FLOOR_SEEDS seeds, and the
# limit twice the floor.  The loss and the global gradient norm are
# aggregates whose floor readings spread 1.6× between two seeds (the
# first H100 run: grad norm 1.23e-4 and 7.7e-5 against the kernel's
# 2.54e-4), so the floor takes four.
TRAIN_E2E_SEQ = 4096
TRAIN_FLOOR_SEEDS = (1, 2, 3, 4)
# (d): the substrate on a cut of the full width to SUBSTRATE_LAYERS
# layers, at SUBSTRATE_BATCH × SUBSTRATE_SEQ
SUBSTRATE_LAYERS, SUBSTRATE_BATCH, SUBSTRATE_SEQ = 2, 2, 512
ADAMW_RTOL = 1e-6          # card vs CPU, over each leaf's largest |value|


def attn_grads_plain(torch, q, k, v, do, kw):
    """dq, dk, dv of autograd through ``attention_ref`` (in the inputs'
    dtype) and its output."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    leaves = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    out = attention_ref(*leaves, **kw)
    out.backward(do)
    return [x.grad for x in leaves], out.detach()


def attn_grads_kernel(q, k, v, do, kw, bwd=None, heads=None):
    """K5 forward with its log-sum-exp, then K5's backward, with the
    backward's options changed by ``bwd`` and, with ``heads``, run on the
    query heads ``heads`` only (a planted fault)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    _, lse = fk.flash_attention(q, k, v, return_lse=True, **kw)
    if heads is not None:
        q, do = (x[:, :, heads].contiguous() for x in (q, do))
        lse = lse[:, heads].contiguous()
    return fk.flash_attention_bwd(q, k, v, do, lse,
                                  **dict(kw, **(bwd or {})))


def bwd_faults(kw, G):
    """The planted faults of K5's backward that apply to options ``kw``
    with G query heads a kv head: name → (bwd options, heads)."""
    faults = {"causal_flipped_in_bwd": ({"causal": not kw["causal"]}, None)}
    if G > 1:
        faults["dkdv_one_head_of_group"] = ({}, "one")
    if kw.get("cap"):
        faults["softcap_dropped_in_bwd"] = ({"cap": None}, None)
    if kw.get("window"):
        faults["window_plus_1_in_bwd"] = ({"window": kw["window"] + 1},
                                          None)
    return faults


def bwd_readings(torch, q, k, v, do, kw):
    """K5's backward against its plain version on one set of f32 inputs
    (rounded to bf16 for the bf16 readings): f32 in RMS units, bf16
    relative, and bf16 as relative RMS against the f32 plain gradients of
    the same bf16 inputs (also the floor's noise in (c), with the
    forward's), each the largest over dq, dk, dv; and the planted faults,
    f32 in RMS units, bf16 as relative RMS (a fault's dq, dk, dv against
    the plain's; the one-head fault reads dk and dv)."""
    H, K_ = q.shape[2], k.shape[2]
    G = H // K_
    ins32 = (q.float(), k.float(), v.float(), do.float())
    ins16 = tuple(x.bfloat16() for x in ins32)
    plain32, _ = attn_grads_plain(torch, *ins32, kw)
    plain16, out_p16 = attn_grads_plain(torch, *ins16, kw)
    plain16f, _ = attn_grads_plain(torch, *(x.float() for x in ins16), kw)
    k32 = attn_grads_kernel(*ins32, kw)
    k16 = attn_grads_kernel(*ins16, kw)
    from repro_torch.kernels.flash_attention import kernel as fk
    out16 = fk.flash_attention(*ins16[:3], **kw)
    r = {"f32_rms_units": max(rms_err(a, b) for a, b in zip(k32, plain32)),
         "bf16_rel": max(rel_err(a, b) for a, b in zip(k16, plain16)),
         "bf16_rms_units": max(rms_err(a, b)
                               for a, b in zip(k16, plain16f)),
         "bf16_rel_rms": max(rel_rms(a, b) for a, b in zip(k16, plain16f)),
         "bf16_max_abs": max(float((a.float() - b.float()).abs().max())
                             for a, b in zip(k16, plain16)),
         "fwd_bf16_rel_rms": rel_rms(out16, out_p16),
         "same_bits_twice": all(torch.equal(a, b) for a, b in zip(
             k16, attn_grads_kernel(*ins16, kw)))}
    one = torch.arange(0, H, G, device=q.device)
    for name, (bwd, heads) in bwd_faults(kw, G).items():
        for dt, ins, plain in (("f32", ins32, plain32),
                               ("bf16", ins16, plain16f)):
            got = attn_grads_kernel(*ins, kw, bwd=bwd,
                                    heads=one if heads else None)
            pairs = zip(got[1:], plain[1:]) if heads else zip(got, plain)
            read = rms_err if dt == "f32" else rel_rms
            r[f"{dt}_fault_{name}"] = max(read(a, b) for a, b in pairs)
    return r


def check_bwd(label, r):
    check(r["f32_rms_units"] <= BWD_F32_LIMIT,
          f"{label}: K5 bwd vs plain in f32: {r['f32_rms_units']:.3e}")
    check(r["bf16_rel"] <= BWD_BF16_LIMIT,
          f"{label}: K5 bwd vs plain in bf16: {r['bf16_rel']:.3e}")
    check(r["bf16_rel_rms"] <= BWD_BF16_RMS_LIMIT,
          f"{label}: K5 bwd bf16 vs f32 plain: {r['bf16_rel_rms']:.3e}")
    check(r["same_bits_twice"], f"{label}: K5 bwd gave other bits twice")
    # every fault over the f32 limit in f32; in bf16 over the bf16 RMS
    # limit, except the window one wider (one more key a row, read only)
    for key, val in r.items():
        if key.startswith("f32_fault_"):
            check(not val <= BWD_F32_LIMIT,
                  f"{label}: K5 bwd's planted fault {key} reads {val:.3e}")
        if key.startswith("bf16_fault_") and "window" not in key:
            check(not val <= BWD_BF16_RMS_LIMIT,
                  f"{label}: K5 bwd's planted fault {key} reads {val:.3e}")


BWD_KERNELS = {route: [f"flash_attention_bwd_{k}{tag}_kernel"
                       for k in ("dkdv", "dq")]
               for route, tag in (("wgmma", "_wgmma"), ("fma", ""))}
# K5's backward at qwen2-moe-a2.7b's training shape (B 2, S = T = 4096,
# 16:16 heads, hd 128), causal, bf16: the wgmma route at hd 128
BWD_HD128_SHAPE = (2, 4096, 16, 16, 128)


def bwd_device_ms(torch, op, calls=5, pad=256, tries=3):
    """Mean device ms of each backward kernel of ``op`` in a profiler
    trace, by its name (``flash_attention_bwd_dq_wgmma_kernel`` ...);
    padded with spin kernels as ``traced_kernel`` is."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    by_name = {}
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(pad):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
            for _ in range(calls):
                op()
            torch.cuda.synchronize()
            for _ in range(pad):
                torch.cuda._sleep(100)
            torch.cuda.synchronize()
        for e in prof.profiler.kineto_results.events():
            m = re.search(r"(flash_attention_bwd_\w+?_kernel)", e.name())
            if e.device_type() == DeviceType.CUDA and m:
                by_name.setdefault(m.group(1), []).append(e.duration_ns())
        if len(by_name) >= 2:
            break
    return {k: sum(d) / len(d) / 1e6 for k, d in sorted(by_name.items())}


def k5_bwd_time(torch, q, k, v, do, kw, plain=True, route="wgmma"):
    """K5's backward at one shape in bf16 (inputs of f32 from a seed):
    op and device ms by kernel, the plain version (forward and backward
    through ``attention_ref``) unless ``plain`` is false, SDPA's
    backward (``enable_gqa``; ``is_causal``, which takes the flash
    backend, or with a window its band as a boolean mask; timed here,
    off the path) and the bound, 10·hd operations a valid (q, k) pair
    (QKᵀ and dO·Vᵀ again, dV, dK, dQ) at the bf16 peak.  Fails unless
    the profiler saw the kernels of ``route``."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import kernel as fk

    B_, S, H, hd = q.shape
    q16, k16, v16, do16 = (x.bfloat16() for x in (q, k, v, do))
    _, lse = fk.flash_attention(q16, k16, v16, return_lse=True, **kw)

    def op():
        return fk.flash_attention_bwd(q16, k16, v16, do16, lse, **kw)

    W = kw.get("window")
    if W:
        pos = torch.arange(S, device=q.device)
        band = ((pos[:, None] >= pos[None, :])
                & (pos[:, None] - pos[None, :] < W))
        sdpa_kw = {"attn_mask": band}
        pairs = B_ * H * sum(min(i + 1, W) for i in range(S))
    else:
        sdpa_kw = {"is_causal": True}
        pairs = B_ * H * S * (S + 1) // 2
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                  for x in (q16, k16, v16))
    o_sdpa = F.scaled_dot_product_attention(qt, kt, vt, scale=1.0,
                                            enable_gqa=True, **sdpa_kw)
    dot = do16.transpose(1, 2)

    def sdpa_bwd():
        return torch.autograd.grad(o_sdpa, (qt, kt, vt), dot,
                                   retain_graph=True)

    ms = timed(torch, op)
    ms_lib = timed(torch, sdpa_bwd)
    ms_plain = (timed(torch, lambda: attn_grads_plain(
        torch, q16, k16, v16, do16, kw), runs=5) if plain else None)
    dev_ms = bwd_device_ms(torch, op)
    check(sorted(dev_ms) == BWD_KERNELS[route],
          f"the profiler saw K5 bwd's kernels {sorted(dev_ms)} at "
          f"{tuple(q.shape)}")
    nbytes = (2 * (2 * q16.numel() + 2 * k16.numel()) + 4 * lse.numel()
              + 2 * (q16.numel() + 2 * k16.numel()))
    rec = {"ms": ms, "plain_ms": ms_plain,
           **dict(zip(("bound_ms", "bound_by"),
                      bound(nbytes, 10 * hd * pairs, BF16_TC_OPS))),
           "library_ms": ms_lib, "kernel_device_ms": sum(dev_ms.values()),
           "kernel_device_ms_by_kernel": dev_ms,
           "shape": {"q": list(q.shape), "kv": list(k.shape), **kw}}
    sdpa_err = max(rel_err(a.transpose(1, 2), b) for a, b in zip(
        sdpa_bwd(), attn_grads_plain(torch, q16, k16, v16, do16, kw)[0]))
    del lse, o_sdpa, qt, kt, vt
    return rec, sdpa_err


def k5_bwd_phase(torch, dev, B_):
    """Phase 18(a): K5's backward against autograd through its plain
    version on llama's path shape at one layer, (B_, TRAIN_SEQ, 32:8, 64)
    causal, and on every case of ``K5_OPTIONS``, inputs from a seed,
    with the backward kernels each bf16 case ran (the wgmma pair on the
    route ``bwd_geometry`` gives it, the FMA pair else); then its times
    (``k5_bwd_time``) at the path shape and at qwen2-moe's hd-128
    training shape ``BWD_HD128_SHAPE``.  Returns (the path's readings,
    the record for the kernels line, K5's forward times)."""
    from repro_torch.kernels.flash_attention import kernel as fk

    gen = torch.Generator(device=dev).manual_seed(18)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    H, K_, hd = 32, 8, 64
    shape_q = (B_, TRAIN_SEQ, H, hd)
    q = randn(*shape_q) * hd ** -0.5
    k, v = randn(B_, TRAIN_SEQ, K_, hd), randn(B_, TRAIN_SEQ, K_, hd)
    do = randn(*shape_q)
    kw = {"causal": True, "window": None, "cap": None}
    path = bwd_readings(torch, q, k, v, do, kw)
    emit({"phase": "train_k5_bwd_path", "q": list(shape_q),
          "kv": list(k.shape), **kw,
          "limits": {"f32": BWD_F32_LIMIT, "bf16": BWD_BF16_LIMIT,
                     "bf16_rms": BWD_BF16_RMS_LIMIT}, **path})
    check_bwd("K5 bwd at the path shape", path)
    got, ran = {}, {}
    for name, ((b, S, T, h, kk, d), causal, window, cap) in \
            K5_OPTIONS.items():
        qo = randn(b, S, h, d) * (60.0 if cap else 1.0) * d ** -0.5
        ko, vo, doo = randn(b, T, kk, d), randn(b, T, kk, d), \
            randn(b, S, h, d)
        kwo = {"causal": causal, "window": window, "cap": cap}
        got[name] = bwd_readings(torch, qo, ko, vo, doo, kwo)
        ins16 = [x.bfloat16() for x in (qo, ko, vo, doo)]
        route = fk.bwd_geometry(b, S, T, h, kk, d, torch.bfloat16,
                                fk.copies_16_bytes(d, 2, *ins16)).route
        ran[name] = {"route": route, "kernels": sorted(bwd_device_ms(
            torch, lambda: attn_grads_kernel(*ins16, kwo), calls=1,
            pad=64))}
    torch.cuda.synchronize()
    emit({"phase": "train_k5_bwd_options", "readings": got,
          "bf16_kernels": ran})
    for name, r in got.items():
        check_bwd(f"K5 bwd {name}", r)
    for name, r in ran.items():
        check(r["kernels"] == BWD_KERNELS[r["route"]],
              f"K5 bwd {name} in bf16 ran {r['kernels']} on the "
              f"{r['route']} route")
        hd_ = K5_OPTIONS[name][0][5]
        want = {33: "fma", 64: "wgmma", 96: "wgmma", 128: "wgmma"}
        check(r["route"] == want.get(hd_, r["route"]),
              f"K5 bwd {name} (hd {hd_}) took the {r['route']} route")

    # times at the path shape and at the hd-128 shape, bf16
    rec, sdpa_err = k5_bwd_time(torch, q, k, v, do, kw)
    rec = {"name": "flash_attention_bwd", "route": "cuda",
           "source": CU_K5_BWD, "replaces": XLA_ATTN, "launches": None,
           "max_abs_err": path["bf16_max_abs"], **rec}
    q16, k16, v16 = (x.bfloat16() for x in (q, k, v))
    ms_fwd = timed(torch, lambda: fk.flash_attention(q16, k16, v16))
    ms_fwd_lse = timed(torch, lambda: fk.flash_attention(
        q16, k16, v16, return_lse=True))
    emit({"phase": "train_k5_bwd_time", **rec,
          "sdpa_bwd_vs_plain_bf16_rel": sdpa_err,
          "k5_fwd_ms": ms_fwd, "k5_fwd_with_lse_ms": ms_fwd_lse})
    del q16, k16, v16
    b2, s2, h2, k2, d2 = BWD_HD128_SHAPE
    q2 = randn(b2, s2, h2, d2) * d2 ** -0.5
    k2_, v2 = randn(b2, s2, k2, d2), randn(b2, s2, k2, d2)
    rec2, sdpa_err2 = k5_bwd_time(torch, q2, k2_, v2, randn(b2, s2, h2, d2),
                                  kw, plain=False)
    emit({"phase": "train_k5_bwd_time_hd128", **rec2,
          "sdpa_bwd_vs_plain_bf16_rel": sdpa_err2})
    rec["hd128_shape"] = rec2
    del q2, k2_, v2
    return path, rec, {"fwd_ms": ms_fwd, "fwd_with_lse_ms": ms_fwd_lse}


def train_noise(torch, rel_fwd, rel_bwd, seed, dev):
    """(pre, post): ``pre(x)`` is x whose gradient gets noise of
    ``rel_bwd`` of its RMS, ``post(o)`` is o with noise of ``rel_fwd`` of
    its RMS (one generator seeded ``seed``): around a plain version they
    make a plain run as far from the plain one as a kernel and its
    backward read."""
    gen = torch.Generator(dev).manual_seed(seed)

    class GradNoise(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            g32 = g.float()
            noise = torch.randn(g.shape, generator=gen, device=g.device)
            return (g32 + noise * (rel_bwd * g32.pow(2).mean().sqrt())
                    ).to(g.dtype)

    def post(out):
        o = out.float()
        noise = torch.randn(o.shape, generator=gen, device=dev)
        scale = rel_fwd * o.detach().pow(2).mean().sqrt()
        return (o + noise * scale).to(out.dtype)
    return GradNoise.apply, post


def perturbed_train_attention(torch, rel_fwd, rel_bwd, seed, dev):
    """The plain attention for training with noise in both directions:
    the output gets ``rel_fwd`` of its RMS, each of dq, dk, dv
    ``rel_bwd`` of theirs (``train_noise``)."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    pre, post = train_noise(torch, rel_fwd, rel_bwd, seed, dev)

    def run(q, k, v, causal=True, window=None, cap=None, impl="auto"):
        return post(attention_ref(pre(q), pre(k), pre(v), causal=causal,
                                  window=window, cap=cap))
    return run


def perturbed_train_scan(torch, rel_fwd, rel_bwd, seed, dev):
    """The plain scan for training with noise in both directions: h gets
    ``rel_fwd`` of its RMS, da and db ``rel_bwd`` of theirs."""
    from repro_torch.kernels.linear_scan.ref import linear_scan_ref
    pre, post = train_noise(torch, rel_fwd, rel_bwd, seed, dev)

    def run(a, b, impl="auto"):
        return post(linear_scan_ref(pre(a), pre(b)))
    return run


def grad_readings(torch, run, ref):
    """Loss (relative), global gradient norm (relative) and the largest
    per-leaf relative gradient distance (‖Δg‖ / ‖g‖) of ``run`` against
    ``ref``, each (total, metrics, grads)."""
    def norm(gs):
        return float(torch.sqrt(sum(g.double().pow(2).sum()
                                    for g in gs.values())))
    n_ref = norm(ref[2])
    leaf = 0.0
    for name, g in ref[2].items():
        gn = float(g.double().norm())
        if gn > 0:
            leaf = max(leaf, float((run[2][name].double() - g.double()
                                    ).norm()) / gn)
    return {"loss": abs(float(run[0]) - float(ref[0])) / abs(float(ref[0])),
            "grad_norm": abs(norm(run[2]) - n_ref) / n_ref,
            "leaf_max": leaf}


def train_end_to_end(torch, dev, model, cfg, sites, expect, noise,
                     tag="train_end_to_end", seeds=TRAIN_FLOOR_SEEDS):
    """One step's loss and gradients at B 1 × TRAIN_E2E_SEQ through the
    kernels and through their plain versions, held to twice the floor:
    the plain run against itself with noise of the kernels' relative
    readings, the largest over ``seeds``.  ``sites`` maps a
    kernel to (module, attribute, plain version, seed → the plain version
    with noise) of its call site in the model; ``expect`` is the kernel
    run's launches (any other kernel must launch none)."""
    from repro_torch.data import SyntheticTokens
    from repro_torch.train.loop import loss_and_grads

    batch = SyntheticTokens(vocab=cfg.vocab, seq_len=TRAIN_E2E_SEQ,
                            global_batch=1, seed=1).batch_at(0)
    reset_all_launches()
    kern = loss_and_grads(model, batch)
    torch.cuda.synchronize()
    n_k = all_launches()
    check(all(n == expect.get(k, 0) for k, n in n_k.items()),
          f"{tag}: the kernel run launched {n_k}, not {expect}")

    def plain_run(fns):
        reset_all_launches()
        with contextlib.ExitStack() as stack:
            for name, (mod, attr, *_) in sites.items():
                stack.enter_context(mock.patch.object(mod, attr, fns[name]))
            out = loss_and_grads(model, batch)
        torch.cuda.synchronize()
        n = all_launches()
        check(not any(n.values()), f"a plain run of {tag} launched: {n}")
        return out

    plain = plain_run({k: v[2] for k, v in sites.items()})
    got = {"kernel": grad_readings(torch, kern, plain)}
    del kern
    for seed in seeds:
        noisy = plain_run({k: v[3](seed) for k, v in sites.items()})
        got[f"floor_seed{seed}"] = grad_readings(torch, noisy, plain)
        del noisy
    floor = {k: max(got[f"floor_seed{s}"][k] for s in seeds)
             for k in got["kernel"]}
    limits = {k: 2 * v for k, v in floor.items()}
    emit({"phase": tag, "tokens": TRAIN_E2E_SEQ,
          "loss_plain": float(plain[0]), "limits": limits, "noise": noise,
          **got})
    for k, lim in limits.items():
        check(got["kernel"][k] <= lim,
              f"{tag}: the kernel step's {k} reads {got['kernel'][k]:.3e} "
              f"over twice the floor, {lim:.3e}")


def attention_site(torch, dev, fwd_rel, bwd_rel):
    """``train_end_to_end``'s site of K5 (and its backward)."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import attention as attn_mod

    def plain(q, k, v, causal=True, window=None, cap=None, impl="auto"):
        return attention_ref(q, k, v, causal=causal, window=window, cap=cap)
    return (attn_mod, "flash_attention_op", plain,
            lambda seed: perturbed_train_attention(torch, fwd_rel, bwd_rel,
                                                   seed, dev))


def _bits(state):
    """Clones of the parameters and moments, and the step."""
    return ({k: v.detach().clone() for k, v in
             state.params.named_parameters()},
            {k: v.clone() for k, v in state.opt_state.mu.items()},
            {k: v.clone() for k, v in state.opt_state.nu.items()},
            int(state.opt_state.step))


def _same_bits(torch, state, bits):
    p, mu, nu, step = bits
    return (all(torch.equal(v, p[k]) for k, v in
                state.params.named_parameters())
            and all(torch.equal(v, mu[k]) for k, v in
                    state.opt_state.mu.items())
            and all(torch.equal(v, nu[k]) for k, v in
                    state.opt_state.nu.items())
            and int(state.opt_state.step) == step)


def train_substrate(torch, np, dev):
    """Phase 18(d) on llama's full width cut to SUBSTRATE_LAYERS layers:
    the NaN guard, save and resume, ``RetryableStep``, ``adamw_update``
    on the card against its CPU run, and the launcher at the smoke
    config."""
    import tempfile
    from repro_torch.configs import get_config
    from repro_torch.data import SyntheticTokens, host_batch_iterator
    from repro_torch.launch import train as launch_train
    from repro_torch.models import init_params
    from repro_torch.train import (AdamWConfig, CheckpointHook,
                                   RetryableStep, TrainState, adamw_init,
                                   adamw_update, checkpoint as ckpt,
                                   make_train_step, train_loop)

    cfg = get_config(TRAIN_ARCH).replace(n_layers=SUBSTRATE_LAYERS)
    opt = AdamWConfig(**TRAIN_OPT)
    step = make_train_step(cfg, opt)
    src = SyntheticTokens(vocab=cfg.vocab, seq_len=SUBSTRATE_SEQ,
                          global_batch=SUBSTRATE_BATCH)

    def fresh(seed=0):
        return TrainState.create(init_params(
            cfg, torch.Generator(device=dev).manual_seed(seed), device=dev,
            dtype=torch.float32, trainable=True))

    def run(state, start, n, hooks=()):
        return [h["loss"] for h in train_loop(
            cfg, opt, state, host_batch_iterator(src, cfg, start), n,
            train_step=step, hooks=hooks, log_every=0)]

    out = {}
    # the NaN guard: a poisoned step leaves every bit
    st = fresh()
    run(st, 0, 1)
    with torch.no_grad():
        st.params.embed[0, 0] = float("inf")
    bits = _bits(st)
    _, _, m = step(st.params, st.opt_state, src.batch_at(1))
    out["nan_guard"] = {"skipped": float(m["skipped"]),
                        "loss": float(m["loss"]),
                        "same_bits": _same_bits(torch, st, bits)}
    check(out["nan_guard"]["skipped"] == 1.0
          and out["nan_guard"]["same_bits"],
          f"(d) the NaN guard: {out['nan_guard']}")
    del st, bits

    with tempfile.TemporaryDirectory() as tmp:
        # save at step 2 and resume: two uninterrupted runs give the spread
        # (one checkpoint only: the three leaves a parameter take 4.6 GB)
        d1 = f"{tmp}/run1"
        st = fresh()
        a = run(st, 0, 2, [CheckpointHook(d1, every=2, asynchronous=False)])
        a += run(st, 2, 2)
        b = run(fresh(), 0, 4)
        st = fresh(seed=5)
        tree, man = ckpt.restore(f"{d1}/step_00000002",
                                 {"params": st.params,
                                  "opt": st.opt_state})
        st.params, st.opt_state, st.step = tree["params"], tree["opt"], \
            man["step"]
        r = run(st, 2, 2)
        spread = max(abs(x - y) for x, y in zip(a[2:], b[2:]))
        out["resume"] = {"uninterrupted": a, "again": b, "resumed": r,
                         "spread": spread,
                         "resumed_vs_uninterrupted": [
                             abs(x - y) for x, y in zip(r, a[2:])]}
        check(all(d <= spread for d in
                  out["resume"]["resumed_vs_uninterrupted"]),
              f"(d) resume: {out['resume']}")

        # RetryableStep: a step made to raise restores step 2 and replays
        d2 = d1
        calls = {"n": 0}

        def flaky(*args):
            calls["n"] += 1
            if calls["n"] == 2:
                raise RuntimeError("CUDA error: a planted failure")
            return step(*args)

        st = fresh(seed=6)
        tree, man = ckpt.restore(f"{d2}/step_00000002",
                                 {"params": st.params, "opt": st.opt_state})
        st.params, st.opt_state, st.step = tree["params"], tree["opt"], \
            man["step"]
        rs = RetryableStep(flaky, d2, max_retries=1)
        losses, restored = [], []
        while st.step < 4:
            res, nxt = rs(st, src.batch_at(st.step))
            if res is None:
                restored.append(nxt)
                continue
            st.params, st.opt_state, m = res
            st.step = nxt
            losses.append(float(m["loss"]))
        out["retry"] = {"calls": calls["n"], "restored_to": restored,
                        "losses": losses, "uninterrupted": a}
        check(restored == [2] and calls["n"] == 4
              and abs(losses[0] - a[2]) <= spread
              and abs(losses[1] - a[2]) <= spread
              and abs(losses[2] - a[3]) <= spread,
              f"(d) RetryableStep: {out['retry']}")
        del st, tree

        # adamw_update on the card against its CPU run on the same grads
        model = fresh().params
        names = ["layers.0.norm1.scale", "layers.0.mixer.wq",
                 "layers.0.mlp.w_gate"]
        params = {n: p.detach().clone() for n, p in
                  model.named_parameters() if n in names}
        del model
        gen = torch.Generator(device=dev).manual_seed(7)
        grads = [{n: torch.randn(p.shape, generator=gen, device=dev) * s
                  for n, p in params.items()} for s in (1e-3, 1e-2, 1.0)]
        cpu = {n: p.cpu() for n, p in params.items()}
        sc, ss = adamw_init(params), adamw_init(cpu)
        for g in grads:
            params, sc, _ = adamw_update(opt, g, sc, params)
            cpu, ss, _ = adamw_update(opt, {n: x.cpu() for n, x in
                                            g.items()}, ss, cpu)
        err = {}
        for n in names:
            for what, x, y in (("p", params[n], cpu[n]),
                               ("mu", sc.mu[n], ss.mu[n]),
                               ("nu", sc.nu[n], ss.nu[n])):
                y = y.to(dev)
                err[f"{n}/{what}"] = float((x - y).abs().max()
                                           / y.abs().max())
        out["adamw_card_vs_cpu"] = {"rtol": ADAMW_RTOL, "readings": err}
        check(max(err.values()) <= ADAMW_RTOL,
              f"(d) adamw_update card vs CPU: {err}")
        del params, cpu, sc, ss, grads

        # the launcher at the smoke config, on the card by default
        reset_all_launches()
        t0 = time.perf_counter()
        hist = launch_train.main(["--steps", "4", "--seq", "128",
                                  "--global-batch", "8",
                                  "--ckpt-dir", f"{tmp}/launcher"])
        torch.cuda.synchronize()
        n = all_launches()
        out["launcher"] = {"losses": [h["loss"] for h in hist],
                           "launches": n,
                           "wall_s": time.perf_counter() - t0}
        check(len(hist) == 4 and all(np.isfinite(h["loss"]) for h in hist)
              and n["flash_attention"] > 0
              and n["flash_attention_bwd"] > 0,
              f"(d) the launcher: {out['launcher']}")
    emit({"phase": "train_substrate", **out})


def train_launches(cfg, seq, micro):
    """The kernel launches a training step of ``cfg`` must make at
    ``seq`` tokens a row in ``micro`` micro-batches under remat "full":
    each K4 and K5 forward twice a layer and micro-batch (the checkpoint
    recomputes it in the backward pass), each backward once; K4 once an
    RG-LRU layer and once a chunk of each Mamba layer."""
    kinds = [cfg.cycle[i % len(cfg.cycle)] for i in range(cfg.n_layers)]
    scans = (kinds.count("rglru")
             + kinds.count("mamba") * -(-seq // min(cfg.scan_chunk, seq)))
    attn = len(kinds) - kinds.count("rglru") - kinds.count("mamba")
    return {"flash_attention": 2 * attn * micro,
            "flash_attention_bwd": attn * micro,
            "linear_scan": 2 * scans * micro,
            "linear_scan_bwd": scans * micro}


def untrained_logits(torch, model, batch, n=512):
    """What the untrained model predicts on the first ``n`` tokens of
    ``batch``'s first row: its loss there, and the share of positions
    whose largest logit is the input token or the label."""
    from repro_torch.models.transformer import model_apply
    row = {k: v[:1, :n] for k, v in batch.items()}
    with torch.no_grad():
        loss, _, logits = model_apply(model, row, return_logits=True)
        top = logits.argmax(-1).cpu()
    return {"tokens": n, "loss": float(loss),
            "argmax_is_input": float((top == torch.as_tensor(
                row["tokens"])).float().mean()),
            "argmax_is_label": float((top == torch.as_tensor(
                row["labels"])).float().mean())}


def train_main_path(torch, np, dev, cfg, arch, tag, steps, batch, seq,
                    micro, falls="last"):
    """A training main path, counted: ``cfg`` at full width (f32 masters,
    seed 0) trains ``steps`` steps of ``SyntheticTokens`` at ``batch`` ×
    ``seq`` in ``micro`` micro-batches through ``make_train_step``/
    ``train_loop`` with the launcher's AdamW.  Every loss finite, the
    first within 1 of ln V (for a tied √d-scaled embedding, which
    untrained predicts the input token, within the reference's (0, 3 ln
    V)), no step skipped, exactly ``train_launches`` a step, and the loss
    falls: the last below the first, or with ``falls="first_update"``
    the second (after one AdamW step) below the first.  Prints the
    ``tag`` line, with what the untrained model predicts
    (``untrained_logits``), and returns (the train state, the launches, a
    step's launches, the figures)."""
    from repro_torch.data import SyntheticTokens, host_batch_iterator
    from repro_torch.models import init_params
    from repro_torch.train import (AdamWConfig, TrainState, make_train_step,
                                   train_loop)

    check(cfg.remat == "full" and cfg.dtype == "bfloat16",
          f"{arch}'s training config changed")
    t0 = time.perf_counter()
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev, dtype=torch.float32, trainable=True)
    n_params = sum(p.numel() for p in model.parameters())
    state = TrainState.create(model)
    opt = AdamWConfig(**TRAIN_OPT)
    step = make_train_step(cfg, opt, microbatches=micro)
    src = SyntheticTokens(vocab=cfg.vocab, seq_len=seq, global_batch=batch)
    init = untrained_logits(torch, model, src.batch_at(0))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_all_launches()
    hist = train_loop(cfg, opt, state, host_batch_iterator(src, cfg),
                      steps, train_step=step, log_every=0)
    torch.cuda.synchronize()
    launches = all_launches()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    step_ms = [h["step_time_s"] * 1e3 for h in hist]
    steady = sorted(step_ms[1:])[len(step_ms[1:]) // 2]
    per_step = {k: v / steps for k, v in launches.items()}
    want = train_launches(cfg, seq, micro)
    emit({"phase": tag, "arch": arch, "layers": cfg.n_layers,
          "params": n_params, "batch": batch, "seq": seq,
          "microbatches": micro, "remat": cfg.remat,
          "losses": losses, "grad_norms": [h["grad_norm"] for h in hist],
          "lr": [h["lr"] for h in hist],
          "skipped": [h["skipped"] for h in hist], "step_ms": step_ms,
          "step_ms_median_after_first": steady,
          "tokens_per_s": batch * seq / (steady / 1e3),
          "peak_memory_gb": peak / 1e9, "launches": launches,
          "launches_per_step": per_step, "expected_per_step": want,
          "init": init, "wall_s": time.perf_counter() - t0})
    check(all(np.isfinite(losses)), f"{arch}: a loss not finite: {losses}")
    ln_v = np.log(cfg.vocab)
    if cfg.embed_scale and cfg.tie_embeddings:
        # untrained, a tied √d-scaled embedding predicts the input token
        # (``init`` in the line): the reference's own bound on an
        # untrained loss, tests/models/test_archs.py:41
        first_ok = 0 < losses[0] < 3 * ln_v
    else:
        first_ok = abs(losses[0] - ln_v) < 1
    fell = losses[1 if falls == "first_update" else -1] < losses[0]
    check(fell and first_ok,
          f"{arch}: the training loss does not fall from ln V: {losses}")
    check(not any(h["skipped"] for h in hist),
          f"{arch}: a training step was skipped")
    check(all(n == want.get(k, 0) for k, n in per_step.items()),
          f"{arch}: launches a step {per_step}, not {want}")
    return state, launches, per_step, {"step_ms": steady,
                                       "peak_memory_gb": peak / 1e9}


def train_phase(torch, np, dev):
    """Phase 18: (a) K5's backward against its plain version and its
    times; (b) llama3.2-1b at full width and depth trains TRAIN_STEPS
    steps through ``make_train_step``/``train_loop``, counted; (c) one
    step through the kernels against the plain versions; (d) the
    substrate.  Returns (launches of (b), K5 bwd's record, K5's training
    figures)."""
    from repro_torch.configs import get_config

    cfg = get_config(TRAIN_ARCH)
    check(cfg.tie_embeddings, f"{TRAIN_ARCH}'s training config changed")
    mb = TRAIN_BATCH // TRAIN_MICRO
    t0 = time.perf_counter()
    path, rec, fwd = k5_bwd_phase(torch, dev, mb)
    emit({"phase": "train_k5_bwd", "wall_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()

    # (b) the main path, counted
    state, launches, per_step, figs = train_main_path(
        torch, np, dev, cfg, TRAIN_ARCH, "train_main_path", TRAIN_STEPS,
        TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO)

    # (c) kernel against plain, end to end
    t0 = time.perf_counter()
    L = cfg.n_layers
    train_end_to_end(
        torch, dev, state.params, cfg,
        {"K5": attention_site(torch, dev, path["fwd_bf16_rel_rms"],
                              path["bf16_rel_rms"])},
        {"flash_attention": 2 * L, "flash_attention_bwd": L},
        {"fwd_rel_rms": path["fwd_bf16_rel_rms"],
         "bwd_rel_rms": path["bf16_rel_rms"]})
    emit({"phase": "train_end_to_end_wall", "wall_s":
          time.perf_counter() - t0})
    del state
    torch.cuda.empty_cache()

    # (d) the substrate
    t0 = time.perf_counter()
    train_substrate(torch, np, dev)
    emit({"phase": "train_substrate_wall",
          "wall_s": time.perf_counter() - t0})
    torch.cuda.empty_cache()
    rec["launches"] = launches["flash_attention_bwd"]
    rec["launches_per_step"] = per_step["flash_attention_bwd"]
    return launches, rec, {"launches_per_step":
                           per_step["flash_attention"], **fwd, **figs}


# ---- phase 19: training through K4's backward ------------------------------
# K4's backward (``linear_scan_bwd.cu``) behind ``ops.LinearScan``, and
# the two scan archs training at full width.  (a) The backward against
# autograd through the plain scan (``linear_scan_ref``) at RG-LRU's path
# shape (one layer's (B, 4096, 2560) a micro-batch), at Mamba's chunk
# (B, 256, d_inner·N) with a nonzero carry folded into its first step,
# and on every ``K4_OPTIONS`` case; past K4_BWD_AUTOGRAD_MAX_S steps
# (the 65,536-step chain, whose autograd graph is a few host-issued
# operations a step, twice over) against ``linear_scan_bwd_ref``, the
# reverse loop the CPU tests hold to ``jax.vjp``.  f32 in units of the
# plain gradient's RMS at K4's own limit, bf16 relative at phase 8's
# (the bf16 backward reads the saved h in bf16), the same bits twice;
# the planted faults (the carry
# dropped at every chunk boundary, da reading h_t for h_{t−1}, the
# coefficient a_t for a_{t+1}) over the f32 limit.  At the path shapes
# K4's forward is read for the same bits twice too, not held: its
# look-back stops wherever it first finds a prefix.  (a′) K5 at recurrentgemma's local layer (hd
# 256, window 2048: the bf16 backward takes the FMA pair): the forward's
# log-sum-exp against the plain scores', and the backward at phase
# 18(a)'s limits and faults.  (b) recurrentgemma-2b (26 layers) and (c)
# falcon-mamba-7b at MAMBA_LAYERS of 64 train SCAN_TRAIN_STEPS steps of
# SCAN_TRAIN_BATCH × TRAIN_SEQ tokens in SCAN_TRAIN_MICRO micro-batches,
# each freed before the next; (d) one step at 1 × TRAIN_E2E_SEQ through
# the kernels and through the plain versions at a cut depth
# (``SCAN_E2E_LAYERS``), within twice the floor of the plain run with
# noise of (a)'s and (a′)'s relative readings.
CU_K4_BWD = "src/repro_torch/kernels/linear_scan/csrc/linear_scan_bwd.cu"
# K4's backward replaces no Pallas kernel: the JAX package trains through
# autodiff of its associative scan
XLA_SCAN = "src/repro/models/scan_ops.py:31"
K4_BWD_F32_LIMIT = 1e-4
K4_BWD_AUTOGRAD_MAX_S = 4096
K4_RGLRU_SHAPE = (2, 4096, 2560)
K4_MAMBA_SHAPE = (2, 256, 131072)
# recurrentgemma's local layer: (B, S, H, K, hd), its window
K5_LOCAL_SHAPE, K5_LOCAL_WINDOW = (2, 4096, 10, 1, 256), 2048
LSE_LIMIT = 1e-3           # max |Δ| of the log-sum-exp (nats)
SCAN_ARCHS = ("recurrentgemma-2b", MAMBA_ARCH)
SCAN_TRAIN_STEPS, SCAN_TRAIN_BATCH, SCAN_TRAIN_MICRO = 4, 4, 2
SCAN_TRAIN_LAYERS = {MAMBA_ARCH: MAMBA_LAYERS}
# (d)'s depth: recurrentgemma's one pattern period (two RG-LRU layers and
# a local one), two Mamba layers.  Its floor takes two seeds: with four
# (the first H100 run) the two archs' floors spread at most 13× in the
# loss and 11× in the gradient norm between seeds, and the kernel read
# under the smallest floor of seeds 1 and 2 on every reading but
# recurrentgemma's loss (2.1e-6 against 1.5e-5 and 1.2e-6)
SCAN_E2E_LAYERS = {"recurrentgemma-2b": 3, MAMBA_ARCH: 2}
SCAN_FLOOR_SEEDS = (1, 2)


def scan_grads_plain(torch, a, b, h, dh):
    """da, db of the plain scan: autograd through ``linear_scan_ref`` up to
    K4_BWD_AUTOGRAD_MAX_S steps, else ``linear_scan_bwd_ref`` on the
    kernel's forward output h, as the backward kernel gets it."""
    from repro_torch.kernels.linear_scan.ref import (linear_scan_bwd_ref,
                                                     linear_scan_ref)
    if a.shape[1] > K4_BWD_AUTOGRAD_MAX_S:
        return linear_scan_bwd_ref(a, h, dh)
    leaves = [x.detach().clone().requires_grad_() for x in (a, b)]
    return torch.autograd.grad(linear_scan_ref(*leaves), leaves, dh)


def scan_bwd_faults(a, h, dh):
    """K4's backward with a planted fault, each on the kernel: name → (da,
    db).  The carry dropped at every chunk boundary (each chunk run as
    its own sequence), da reading h_t for h_{t−1}, and the coefficient
    a_t for a_{t+1}."""
    import torch
    from repro_torch.kernels.linear_scan import kernel as sk
    B_, S, D = a.shape
    c = sk.BWD_CHUNK
    n = -(-S // c)
    out = {}
    if S > c:
        def seg(x, fill):
            x = torch.cat([x, x.new_full((B_, n * c - S, D), fill)], 1)
            return x.reshape(B_ * n, c, D)
        da, db = sk.linear_scan_bwd(seg(a, 1.0), seg(h, 0.0), seg(dh, 0.0))
        out["carry_dropped_at_chunks"] = tuple(
            x.reshape(B_, n * c, D)[:, :S] for x in (da, db))
    if S > 1:
        out["da_reads_h_t"] = sk.linear_scan_bwd(
            a, h.roll(-1, 1).contiguous(), dh)
        out["coefficient_a_t"] = sk.linear_scan_bwd(
            a.roll(1, 1).contiguous(), h, dh)
    return out


def k4_bwd_readings(torch, a, b, dh, forward=False):
    """K4's backward against its plain version on one set of f32 inputs
    (rounded to bf16 for the bf16 readings), each the largest over da and
    db: f32 in RMS units and as relative RMS ((d)'s noise), bf16
    relative, the same bits twice, and the planted faults in f32 RMS
    units; with ``forward`` also K4's own relative RMS ((d)'s noise) and
    whether it gave the same bits twice."""
    from repro_torch.kernels.linear_scan import kernel as sk
    from repro_torch.kernels.linear_scan.ref import linear_scan_ref

    def worst(read, xs, ys):
        # a plain gradient that is all zero (da of one step) reads the
        # kernel's largest |value|, which must be 0 too
        return max(read(x, y) if bool(y.any())
                   else float(x.float().abs().max()) for x, y in zip(xs, ys))

    h = sk.linear_scan(a, b)
    got = sk.linear_scan_bwd(a, h, dh)
    plain = scan_grads_plain(torch, a, b, h, dh)
    r = {"f32_rms_units": worst(rms_err, got, plain),
         "f32_rel_rms": worst(rel_rms, got, plain),
         "f32_max_abs": max(float((x - y).abs().max())
                            for x, y in zip(got, plain)),
         "same_bits_twice": all(torch.equal(x, y) for x, y in zip(
             got, sk.linear_scan_bwd(a, h, dh)))}
    if forward:
        r["fwd_f32_rel_rms"] = rel_rms(h, linear_scan_ref(a, b))
        r["fwd_same_bits_twice"] = bool(torch.equal(h, sk.linear_scan(a, b)))
    a16, b16, dh16 = a.bfloat16(), b.bfloat16(), dh.bfloat16()
    h16 = sk.linear_scan(a16, b16)
    r["bf16_rel"] = worst(rel_err, sk.linear_scan_bwd(a16, h16, dh16),
                          scan_grads_plain(torch, a16, b16, h16, dh16))
    for name, f in scan_bwd_faults(a, h, dh).items():
        r[f"fault_{name}"] = worst(rms_err, f, plain)
    return r


def check_k4_bwd(label, r):
    check(r["f32_rms_units"] <= K4_BWD_F32_LIMIT,
          f"{label}: K4 bwd vs plain in f32: {r['f32_rms_units']:.3e}")
    check(r["bf16_rel"] <= BF16_LIMIT,
          f"{label}: K4 bwd vs plain in bf16: {r['bf16_rel']:.3e}")
    check(r["same_bits_twice"], f"{label}: K4 bwd gave other bits twice")
    for key, val in r.items():
        if key.startswith("fault_"):
            check(not val <= K4_BWD_F32_LIMIT,
                  f"{label}: K4 bwd's planted fault {key} reads {val:.3e}")


def k4_inputs(torch, gen, shape, carry=False):
    """a in (0.8, 1), b of std 0.1, dh standard normal; with ``carry`` a
    state of std 1 folded into b's first step, as Mamba's chunks fold
    theirs."""
    dev = gen.device
    a = 0.8 + 0.2 * torch.rand(shape, generator=gen, device=dev)
    b = 0.1 * torch.randn(shape, generator=gen, device=dev)
    if carry:
        b[:, 0] += a[:, 0] * torch.randn(shape[0], shape[2], generator=gen,
                                         device=dev)
    return a, b, torch.randn(shape, generator=gen, device=dev)


def k4_bwd_time(torch, a, b, dh):
    """K4's backward at one f32 shape: op ms, device ms, the plain
    version's ms (``linear_scan_bwd_ref``, 3 runs) and the bound (a, h, dh
    read, da, db written; four operations an element)."""
    from repro_torch.kernels.linear_scan import kernel as sk
    from repro_torch.kernels.linear_scan.ref import linear_scan_bwd_ref
    h = sk.linear_scan(a, b)
    ms = timed(torch, lambda: sk.linear_scan_bwd(a, h, dh))
    ms_plain = timed(torch, lambda: linear_scan_bwd_ref(a, h, dh), runs=3)
    mine, _ = traced_kernel(torch, lambda: sk.linear_scan_bwd(a, h, dh),
                            "linear_scan_bwd_kernel")
    check(mine, f"the profiler saw no K4 bwd kernel at {tuple(a.shape)}")
    b_ms, by = bound(a.element_size() * 5 * a.numel(), 4 * a.numel())
    return {"ms": ms, "plain_ms": ms_plain, "bound_ms": b_ms,
            "bound_by": by, "library_ms": None,
            "kernel_device_ms": sum(mine) / 1e6 / len(mine),
            "traced_launches": len(mine), "shape": list(a.shape)}


def k4_bwd_phase(torch, dev):
    """Phase 19(a): K4's backward on RG-LRU's and Mamba's path shapes and
    on ``K4_OPTIONS``, then its times at both path shapes.  Returns (the
    path readings by arch, the record for the kernels line)."""
    from repro_torch.kernels.linear_scan import kernel as sk
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(19)
    # each arch's path shape; Mamba's chunk with a carry folded in
    shapes = {"recurrentgemma-2b": (K4_RGLRU_SHAPE, False),
              MAMBA_ARCH: (K4_MAMBA_SHAPE, True)}
    paths = {arch: k4_bwd_readings(torch, *k4_inputs(torch, gen, *shape),
                                   forward=True)
             for arch, shape in shapes.items()}
    got = {}
    for name, shape in K4_OPTIONS.items():
        if shape != K4_RGLRU_SHAPE:    # the serving shape is RG-LRU's path
            got[name] = k4_bwd_readings(torch, *k4_inputs(torch, gen, shape))
    torch.cuda.synchronize()
    emit({"phase": "train_k4_bwd", "chunk": sk.BWD_CHUNK, "limits": {
        "f32": K4_BWD_F32_LIMIT, "bf16": BF16_LIMIT},
        "paths": paths, "options": got,
        "wall_s": time.perf_counter() - t0})
    for label, r in [*paths.items(), *got.items()]:
        check_k4_bwd(f"K4 bwd {label}", r)
    recs = {}
    for arch, shape in shapes.items():
        recs[arch] = k4_bwd_time(torch, *k4_inputs(torch, gen, *shape))
        emit({"phase": "train_k4_bwd_time", "arch": arch, **recs[arch]})
    rg = recs["recurrentgemma-2b"]
    rec = {"name": "linear_scan_bwd", "route": "cuda", "source": CU_K4_BWD,
           "replaces": XLA_SCAN, "launches": None,
           "max_abs_err": paths["recurrentgemma-2b"]["f32_max_abs"],
           **{k: rg[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms", "kernel_device_ms", "shape")},
           "mamba_chunk": recs[MAMBA_ARCH]}
    return paths, rec


def lse_plain(torch, q, k, kw):
    """Each row's log-sum-exp of the plain masked scores, f32 (B, H, S)."""
    B_, S, H, hd = q.shape
    T, K_ = k.shape[1], k.shape[2]
    s = torch.einsum("bskgd,btkd->bkgst",
                     q.reshape(B_, S, K_, H // K_, hd).float(), k.float())
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(T, device=q.device)[None]
    mask = torch.ones(S, T, dtype=torch.bool, device=q.device)
    if kw["causal"]:
        mask &= qp >= kp
    if kw["window"]:
        mask &= (qp - kp) < kw["window"]
    s = torch.where(mask, s, float("-inf"))
    return torch.logsumexp(s, -1).reshape(B_, H, S)


def k5_local_phase(torch, dev):
    """Phase 19(a′): K5 at recurrentgemma's local layer: the forward's
    log-sum-exp against the plain scores' (f32 and bf16; the causal mask
    flipped must read over the limit), the backward at phase 18(a)'s
    limits and faults, and its times (the FMA pair; SDPA's backward with
    the window as a boolean mask the yardstick).  Returns (the readings,
    the hd-256 record)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(191)
    B_, S, H, K_, hd = K5_LOCAL_SHAPE
    q = torch.randn(B_, S, H, hd, generator=gen, device=dev) * hd ** -0.5
    k, v = (torch.randn(B_, S, K_, hd, generator=gen, device=dev)
            for _ in range(2))
    do = torch.randn(B_, S, H, hd, generator=gen, device=dev)
    kw = {"causal": True, "window": K5_LOCAL_WINDOW, "cap": None}
    lse = {}
    for dt in (torch.float32, torch.bfloat16):
        qd, kd, vd = (x.to(dt) for x in (q, k, v))
        ref = lse_plain(torch, qd, kd, kw)
        for name, kw_ in (("sound", kw), ("fault_causal_flipped",
                                          dict(kw, causal=False))):
            _, got = fk.flash_attention(qd, kd, vd, return_lse=True, **kw_)
            lse[f"{str(dt)[6:]}_{name}"] = float((got - ref).abs().max())
        del ref
    r = bwd_readings(torch, q, k, v, do, kw)
    ins16 = [x.bfloat16() for x in (q, k, v, do)]
    route = fk.bwd_geometry(B_, S, S, H, K_, hd, torch.bfloat16,
                            fk.copies_16_bytes(hd, 2, *ins16)).route
    emit({"phase": "train_k5_local", "q": [B_, S, H, hd],
          "kv": [B_, S, K_, hd], **kw, "route": route,
          "lse_limit": LSE_LIMIT, "lse": lse,
          "limits": {"f32": BWD_F32_LIMIT, "bf16": BWD_BF16_LIMIT,
                     "bf16_rms": BWD_BF16_RMS_LIMIT}, **r})
    for key, val in lse.items():
        ok = val <= LSE_LIMIT
        check(ok if "fault" not in key else not ok,
              f"K5's log-sum-exp at hd {hd}: {key} reads {val:.3e}")
    check_bwd(f"K5 bwd at hd {hd}", r)
    check(route == "fma", f"K5 bwd at hd {hd} took the {route} route")
    rec, sdpa_err = k5_bwd_time(torch, q, k, v, do, kw, plain=False,
                                route="fma")
    emit({"phase": "train_k5_local_time", **rec,
          "sdpa_bwd_vs_plain_bf16_rel": sdpa_err,
          "wall_s": time.perf_counter() - t0})
    return r, rec


def scan_train_config(arch, layers=None):
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    layers = layers or SCAN_TRAIN_LAYERS.get(arch)
    return cfg.replace(n_layers=layers) if layers else cfg


def scan_sites(torch, dev, arch, k4, k5):
    """``train_end_to_end``'s call sites of ``arch``: K4 with noise of
    (a)'s f32 readings ``k4``, and recurrentgemma's K5 with noise of
    (a′)'s bf16 readings ``k5``."""
    sites = {}
    for name, (mod, attr, plain) in kernel_sites(arch).items():
        if name == "K5":
            sites[name] = attention_site(torch, dev, k5["fwd_bf16_rel_rms"],
                                         k5["bf16_rel_rms"])
        else:
            sites[name] = (mod, attr, plain,
                           lambda seed: perturbed_train_scan(
                               torch, k4["fwd_f32_rel_rms"],
                               k4["f32_rel_rms"], 1000 + seed, dev))
    return sites


def scan_train_phase(torch, np, dev):
    """Phase 19: (a) K4's backward, (a′) K5 at hd 256, (b)–(c) the two
    scan archs train, counted, (d) kernel against plain end to end.
    Returns (the launches of (b) and (c) by arch, K4 bwd's record, K5
    bwd's hd-256 record)."""
    from repro_torch.models import init_params

    t0 = time.perf_counter()
    k4_paths, k4_rec = k4_bwd_phase(torch, dev)
    torch.cuda.empty_cache()
    k5_read, k5_rec = k5_local_phase(torch, dev)
    torch.cuda.empty_cache()
    emit({"phase": "train_scan_kernels", "wall_s": time.perf_counter() - t0})

    launches, figs = {}, {}
    for arch in SCAN_ARCHS:
        cfg = scan_train_config(arch)
        state, n, per_step, figs[arch] = train_main_path(
            torch, np, dev, cfg, arch, f"train_scan_{arch}",
            SCAN_TRAIN_STEPS, SCAN_TRAIN_BATCH, TRAIN_SEQ,
            SCAN_TRAIN_MICRO, falls="first_update")
        launches[arch] = {"total": n, "per_step": per_step}
        del state
        torch.cuda.empty_cache()

    # (d) kernel against plain, end to end, at a cut depth
    for arch in SCAN_ARCHS:
        t0 = time.perf_counter()
        cfg = scan_train_config(arch, SCAN_E2E_LAYERS[arch])
        model = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                            device=dev, dtype=torch.float32, trainable=True)
        k4 = k4_paths[arch]
        train_end_to_end(
            torch, dev, model, cfg, scan_sites(torch, dev, arch, k4, k5_read),
            train_launches(cfg, TRAIN_E2E_SEQ, 1),
            {"k4_fwd_rel_rms": k4["fwd_f32_rel_rms"],
             "k4_bwd_rel_rms": k4["f32_rel_rms"],
             "k5_fwd_rel_rms": k5_read["fwd_bf16_rel_rms"],
             "k5_bwd_rel_rms": k5_read["bf16_rel_rms"]},
            tag=f"train_scan_end_to_end_{arch}", seeds=SCAN_FLOOR_SEEDS)
        emit({"phase": "train_scan_end_to_end_wall", "arch": arch,
              "layers": cfg.n_layers, "wall_s": time.perf_counter() - t0})
        del model
        torch.cuda.empty_cache()
    k4_rec["launches"] = sum(launches[a]["total"]["linear_scan_bwd"]
                             for a in SCAN_ARCHS)
    k4_rec["launches_per_step"] = {
        a: launches[a]["per_step"]["linear_scan_bwd"] for a in SCAN_ARCHS}
    k4_rec["train"] = figs
    return launches, k4_rec, k5_rec


def main():
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    # ---- 1. the card ------------------------------------------------------
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 is compared below
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "card", "nvidia_smi": card, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    from repro_torch.core import (cdr_violation, fit_power, hesrpt_policy,
                                  log_speedup, power, shifted_power,
                                  simulate_policy, smartfill,
                                  smartfill_batched, solve_cap_batched,
                                  solve_cap_regular)
    from repro_torch.core.speedup import StackedSpeedup
    from repro_torch.kernels import _build
    from repro_torch.kernels.gwf_waterfill import kernel as wk
    from repro_torch.kernels.gwf_waterfill import ops

    # ---- 2. the build -----------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build_all()
    build_s = time.perf_counter() - t0
    usage, tensor_ops = build_report(_build)
    emit({"phase": "build", "seconds": build_s, "sources": sorted(reports),
          "ptxas": usage, "K5_sass": tensor_ops,
          "K5_bwd_registers": {k: u.get("registers") for k, u in
                               usage.items()
                               if k.startswith("flash_attention_bwd_")},
          "K4_spills": {k: u.get("spill_store_bytes", 0) for k, u in
                        usage.items() if k.startswith("linear_scan")}})

    # ---- inputs, made from a seed -----------------------------------------
    rng = np.random.default_rng(0)
    C, b, (A_mix, w_mix, g_mix, s_mix) = cap_instance(rng, N, K, 1.0, 40.0)
    m3 = 3 * K // 4                               # 25% inactive bottles
    c3 = np.sort(rng.uniform(0.01, 1.0, K))[::-1].copy()
    b3 = 200.0

    Cd = torch.tensor(C, dtype=torch.float32, device=dev)
    act = Cd > 0
    bd = torch.tensor(b, dtype=torch.float32, device=dev)
    sp_shift = shifted_power(1.0, 4.0, 0.5, B, device=dev)
    sp_mix = StackedSpeedup(
        *(torch.tensor(x, dtype=torch.float64, device=dev)
          for x in (A_mix, w_mix, g_mix, s_mix)), B=B)
    act3, u3, h3 = level_bottles(torch, c3, dev)
    torch.cuda.synchronize()

    # ---- 3–4. the main path, counted ----------------------------------------
    wk.reset_launches()
    th1 = solve_cap_batched(sp_shift, bd, Cd, act, impl="auto", iters=ITERS)
    th2 = solve_cap_batched(sp_mix, bd, Cd, act, impl="auto", iters=ITERS)
    th3 = ops.gwf_waterfill_op(u3, h3, b3, iters=ITERS)
    torch.cuda.synchronize()
    launches = dict(wk.LAUNCHES)
    emit({"phase": "main_path", "launches": launches})
    for name, count in launches.items():
        check(count >= 1, f"{name} was not launched on the main path")
    for name, th in (("K1", th1), ("K2", th2), ("K3", th3)):
        check(th.is_cuda and th.dtype == torch.float32, f"{name} output type")
        check(bool(torch.isfinite(th).all()), f"{name} output not finite")
    check(th1.shape == (N, K) and th2.shape == (N, K) and th3.shape == (K,),
          "output shapes")

    # ---- 3. K1 and K2 against their plain versions ------------------------
    # The JAX kernel tests' tolerances stay as outer bounds; the scaled
    # and KKT checks below are the ones a wrong kernel fails.
    k_act = act.sum(1).double()
    scale = bd.double() / k_act                   # mean allocation per row
    rows = torch.clamp_min(bd, 1.0)[:, None]
    Af, wf, gf = (sp_shift.A.float().expand(N), sp_shift.w.float().expand(N),
                  sp_shift.gamma.float().expand(N))
    fam1 = (Cd, Af[:, None], wf[:, None], gf[:, None],
            torch.ones_like(Af)[:, None], bd)
    plain1 = ops.generic_waterfill_op(Cd, Af, wf, gf, bd, sigma=1,
                                      iters=ITERS, impl="ref")
    err1 = float((th1 - plain1).abs().max())
    check(bool(((th1 - plain1).abs() <= 2e-4 * rows).all()),
          f"K1 vs plain: max |Δ| {err1:.3e} > 2e-4·max(1, b)")
    closed = solve_cap_regular(sp_shift, bd.double(), Cd.double(), act)
    err1c = float((th1.double() - closed).abs().max())
    check(err1c <= 2e-3, f"K1 vs f64 solve_cap_regular: {err1c:.3e} > 2e-3")
    short1 = ops.generic_waterfill_op(Cd, Af, wf, gf, bd, sigma=1,
                                      iters=SHORT_ITERS, impl="cuda")
    faults1 = planted_faults(th1, *fam1, short1)

    mix32 = [torch.tensor(x, dtype=torch.float32, device=dev)
             for x in (A_mix, w_mix, g_mix, s_mix)]
    fam2 = (Cd, *mix32, bd)
    plain2 = ops.hetero_waterfill_op(Cd, *mix32, bd, iters=ITERS, impl="ref")
    err2 = float((th2 - plain2).abs().max())
    check(err2 <= 5e-3, f"K2 vs plain: max |Δ| {err2:.3e} > 5e-3")
    check(bool((th2[~act] == 0).all()), "K2 padding lanes not zero")
    short2 = ops.hetero_waterfill_op(Cd, *mix32, bd, iters=SHORT_ITERS,
                                     impl="cuda")
    faults2 = planted_faults(th2, *fam2, short2)

    readings = {}
    for name, th, fam, refs, faults in (
            ("K1", th1, fam1, {"plain": plain1, "closed_f64": closed},
             faults1),
            ("K2", th2, fam2, {"plain": plain2}, faults2)):
        lim = ALLOC_LIMIT[name]
        r = {f"alloc_vs_{k}": alloc_err(th, ref, scale)
             for k, ref in refs.items()}
        r["kkt_spread"], r["kkt_park"] = kkt_residual(th, *fam)
        readings[name] = r
        check(max(r[f"alloc_vs_{k}"] for k in refs) <= lim
              and max(r["kkt_spread"], r["kkt_park"]) <= KKT_LIMIT,
              f"{name}: readings {r} beyond alloc {lim}, KKT {KKT_LIMIT}")
        for what, thf in faults.items():
            f = {"alloc": alloc_err(thf, refs["plain"], scale)}
            f["kkt_spread"], f["kkt_park"] = kkt_residual(thf, *fam)
            readings[f"{name}_fault_{what}"] = f
            check(f["alloc"] > lim
                  or max(f["kkt_spread"], f["kkt_park"]) > KKT_LIMIT,
                  f"{name}: the planted fault {what} passes the checks: {f}")
    emit({"phase": "cap_front_door", "K1_vs_plain": err1,
          "K1_vs_closed_f64": err1c, "K2_vs_plain": err2,
          "limits": {"alloc": ALLOC_LIMIT, "kkt": KKT_LIMIT},
          "readings": readings})
    dtype_rule_phase(torch, sp_shift, bd, Cd, act)
    cap_options_phase(torch, dev)

    # ---- 4. K3 against its plain version and the f64 closed form ----------
    plain3 = ops.gwf_waterfill_op(u3, h3, b3, iters=ITERS, impl="ref")
    err3 = float((th3 - plain3).abs().max())
    tol3 = 1e-2 * max(1.0, b3 / 10) + 1e-3 * plain3.abs()
    check(bool(((th3 - plain3).abs() <= tol3).all()),
          f"K3 vs plain: max |Δ| {err3:.3e} beyond atol 1e-2·max(1,b/10), "
          "rtol 1e-3")
    ref3 = solve_cap_regular(shifted_power(1.0, 4.0, 0.5, B, device=dev),
                             b3, torch.tensor(c3, device=dev), act3)
    tol3c = 2e-3 * max(1.0, b3 / 10) + 2e-3 * ref3.abs()
    err3c = float((th3.double() - ref3).abs().max())
    check(bool(((th3.double() - ref3).abs() <= tol3c).all()),
          f"K3 vs f64 solve_cap_regular: {err3c:.3e} beyond 2e-3")
    check(bool((th3[m3:] == 0).all()), "K3 inactive bottles not zero")

    def k3_readings(th, ref):
        r = {"alloc": alloc_err(th, ref, b3 / m3)}
        r["level_spread"], r["level_park"], r["sum"] = level_residual(
            th, u3, h3, b3)
        r["bad"] = (r["alloc"] > ALLOC_LIMIT["K3"] or r["sum"] > SUM_LIMIT
                    or max(r["level_spread"], r["level_park"]) > KKT_LIMIT)
        return r

    h_star = level_of(th3, u3, h3, b3)
    faults3 = {"cut_short": ops.gwf_waterfill_op(u3, h3, b3,
                                                 iters=SHORT_ITERS,
                                                 impl="cuda"),
               "park_0.9": torch.where(h3 >= 0.9 * h_star, 0.0, th3),
               "one_slot_late": torch.where(act3, torch.roll(th3, 1), 0.0)}
    readings3 = {"K3_vs_plain": k3_readings(th3, plain3),
                 "K3_vs_closed_f64": k3_readings(th3, ref3)}
    for key in ("K3_vs_plain", "K3_vs_closed_f64"):
        check(not readings3[key]["bad"],
              f"{key}: readings {readings3[key]} beyond the limits")
    for what, thf in faults3.items():
        f = readings3[f"K3_fault_{what}"] = k3_readings(thf, plain3)
        check(f["bad"], f"K3: the planted fault {what} passes the checks: {f}")
    # K3 stops at its fixed point; the cut-short fault only bites while
    # the fixed point lies beyond SHORT_ITERS steps
    fp_steps = fixed_point_steps(
        lambda n: ops.gwf_waterfill_op(u3, h3, b3, iters=n, impl="cuda"),
        th3)
    emit({"phase": "level_wfp", "K3_vs_plain": err3,
          "K3_vs_closed_f64": err3c, "k3_fixed_point_steps": fp_steps,
          "limits": {"alloc": ALLOC_LIMIT["K3"], "level": KKT_LIMIT,
                     "sum": SUM_LIMIT}, "readings": readings3})
    check(fp_steps > SHORT_ITERS,
          f"K3 reaches its fixed point in {fp_steps} ≤ {SHORT_ITERS} steps: "
          "the cut-short fault has nothing to show")
    k3_options_phase(torch, dev)

    # ---- 5. planning on the card, float64 -----------------------------------
    wk.reset_launches()
    t0 = time.perf_counter()
    x8 = np.arange(8, 0, -1.0) * 2.0
    w8 = 1.0 / x8
    sp_log = log_speedup(1.0, 1.0, B, device=dev)
    sched = smartfill(sp_log, x8, w8, B=B)
    check(sched.theta.is_cuda and sched.theta.dtype == torch.float64,
          "quickstart ran off the card or out of float64")
    rel = abs(sched.J - sched.J_linear) / sched.J
    check(rel <= 1e-9, f"quickstart J vs J_linear: {rel:.3e}")
    viol = cdr_violation(sp_log, sched.theta)
    check(max(viol.values()) <= 1e-9, f"CDR violation {viol}")
    a_fit, p_fit = fit_power(lambda t: np.log1p(t), B)
    hes = simulate_policy(sp_log, x8, w8, hesrpt_policy(p_fit, B))
    check(sched.J < hes.J, f"SmartFill J {sched.J} not below heSRPT {hes.J}")
    quick_s = time.perf_counter() - t0
    emit({"phase": "quickstart", "J": sched.J, "J_linear": sched.J_linear,
          "cdr": viol, "hesrpt_J": hes.J, "fit": [a_fit, p_fit],
          "gain": (hes.J - sched.J) / hes.J, "wall_s": quick_s})

    t0 = time.perf_counter()
    rng0 = np.random.default_rng(0)
    Nb, Mb = 256, 16
    X = np.zeros((Nb, Mb))
    W = np.zeros((Nb, Mb))
    ms = rng0.integers(2, Mb + 1, Nb)
    for n in range(Nb):
        xs = np.sort(rng0.uniform(0.5, 20.0, ms[n]))[::-1]
        X[n, :ms[n]] = xs
        W[n, :ms[n]] = 1.0 / xs
    bs = smartfill_batched(sp_log, X, W, B=B)
    n0 = int(np.argmax(ms))
    one = smartfill(sp_log, X[n0, :ms[n0]], W[n0, :ms[n0]], B=B)
    spot = abs(float(bs.J[n0]) - one.J) / one.J
    check(spot <= 1e-9, f"batched vs single |ΔJ|/J {spot:.3e}")
    batched_s = time.perf_counter() - t0
    emit({"phase": "batched_planning", "spot_rel": spot,
          "J_sum": float(bs.J.sum()), "wall_s": batched_s})

    rng1 = np.random.default_rng(1)
    Nf, Mf = 256, 32
    X = np.zeros((Nf, Mf))
    W = np.zeros((Nf, Mf))
    ms = rng1.integers(2, Mf + 1, Nf)
    for n in range(Nf):
        xs = np.sort(rng1.uniform(0.5, 20.0, ms[n]))[::-1]
        X[n, :ms[n]] = xs
        W[n, :ms[n]] = 1.0 / xs
    fleet = {}
    for name, ctor, args in (("power", power, (1.0, 0.5, B)),
                             ("shifted", shifted_power, (1.0, 4.0, 0.5, B)),
                             ("log", log_speedup, (1.0, 1.0, B))):
        t0 = time.perf_counter()
        on_card = smartfill_batched(ctor(*args, device=dev), X, W, B=B)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
        on_cpu = smartfill_batched(ctor(*args, device="cpu"), X, W, B=B)
        Jg = on_card.J.cpu()
        check(on_card.J.is_cuda, f"{name} fleet ran off the card")
        rel = float(((Jg - on_cpu.J).abs() / on_cpu.J).max())
        lin = float(((Jg - on_card.J_linear.cpu()).abs() / Jg).max())
        check(rel <= 1e-9, f"{name} fleet: card vs CPU J {rel:.3e}")
        check(lin <= 1e-9, f"{name} fleet: J vs J_linear {lin:.3e}")
        fleet[name] = {"card_vs_cpu": rel, "J_vs_J_linear": lin,
                       "wall_s": card_s}
    emit({"phase": "fleet_N256_M32", **fleet})
    # the planning path's device busy share: SmartFill's recursion is a
    # long chain of small PyTorch kernels launched from the host
    from torch.profiler import ProfilerActivity, profile
    sp_fleet = log_speedup(1.0, 1.0, B, device=dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        smartfill_batched(sp_fleet, X, W, B=B)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    on_dev = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.device_time_total for e in on_dev) / 1e6
    emit({"phase": "fleet_profile_log", "wall_s": wall, "device_busy_s": busy,
          "busy_share": busy / wall,
          "busy_share_of_unprofiled_wall": busy / fleet["log"]["wall_s"],
          "device_kernels": sum(e.count for e in on_dev)})
    emit({"phase": "planning_launches", "launches": dict(wk.LAUNCHES)})

    # ---- 6. times -----------------------------------------------------------
    n_act = int(act.sum())

    # name: (line of the TPU kernel, op(impl), max |Δ|, bytes, operations).
    # Operations per active job and pass: K1 12 (mul, div, log, mul, exp,
    # sub, mul, max, min, compare, select, add); K2 14 (adds the clamp and
    # 1/γ) plus 20 in its bracket pass; K3 5 (sub, mul, max, min, add),
    # in the steps this instance needs to its fixed point.
    calls = {
        "generic_waterfill": (
            151, lambda impl: ops.generic_waterfill_op(
                Cd, Af, wf, gf, bd, iters=ITERS, impl=impl),
            err1, 4 * (2 * N * K + 4 * N), (ITERS + 1) * n_act * 12),
        "hetero_waterfill": (
            257, lambda impl: ops.hetero_waterfill_op(
                Cd, *mix32, bd, iters=ITERS, impl=impl),
            err2, 4 * (6 * N * K + N), ((ITERS + 1) * 14 + 20) * n_act),
        "gwf_waterfill": (
            82, lambda impl: ops.gwf_waterfill_op(u3, h3, b3, iters=ITERS,
                                                  impl=impl),
            err3, 4 * 3 * K, fp_steps * m3 * 5),
    }
    kernels = []
    for name, (line, op, err, nbytes, nops) in calls.items():
        ms_k = timed(torch, lambda: op("cuda"))
        ms_p = timed(torch, lambda: op("ref"), runs=21)
        b_ms, by = bound(nbytes, nops)
        rec = {"name": name, "route": "cuda", "source": CU,
               "replaces": f"{TPU_KERNELS}:{line}",
               "launches": launches[name], "max_abs_err": err, "ms": ms_k,
               "plain_ms": ms_p, "bound_ms": b_ms, "bound_by": by,
               "library_ms": None}
        kernels.append(rec)
        emit({"phase": "time", **rec})

    # where a call's time goes on the device: the kernel itself vs the
    # wrapper's own small PyTorch kernels (casts, if any).  Averaged per
    # launch of the kernel, so a trace that drops events still gives
    # per-call figures.
    split = {}
    for name, (_, op, *_) in calls.items():
        mine, others = traced_kernel(torch, lambda: op("cuda"),
                                     f"{name}_kernel")
        n = len(mine)
        check(n > 0, f"the profiler saw no {name} kernel on the device")
        split[name] = {"traced_launches": n,
                       "kernel_device_ms": sum(mine) / 1e6 / n,
                       "other_device_ms": sum(others) / 1e6 / n,
                       "device_kernels_per_call": (n + len(others)) / n}
    for rec in kernels:
        sp = split[rec["name"]]
        sp["op_over_kernel_ms"] = rec["ms"] / sp["kernel_device_ms"]
        rec["kernel_device_ms"] = sp["kernel_device_ms"]
    emit({"phase": "profile", **split})
    check(split["generic_waterfill"]["device_kernels_per_call"] <= 2,
          f"K1 launches more than its kernel and one cast a call: "
          f"{split['generic_waterfill']}")

    # ---- 7–10. serving recurrentgemma-2b through K4 and K5 -----------------
    model, batch0, out0, cap, serve_launches = serve_phase(torch, np, dev)
    with torch.inference_mode():
        errs = kernel_phase(torch, cap)
        k5_options_phase(torch, dev)
        k4_options_phase(torch, dev)
        end_to_end_phase(torch, model, batch0, out0, cap)
        kernels += serve_times(torch, cap, serve_launches, errs)
    serve_profile(torch, model, batch0)
    del model, cap                      # phase 16(b) needs the memory
    torch.cuda.empty_cache()

    # ---- 11. per-job SmartFill (§7), float64, counted -----------------------
    t0 = time.perf_counter()
    launches11, hetero_fleet = hetero_phase(torch, np, dev)
    emit({"phase": "hetero_planning", "launches": launches11,
          "wall_s": time.perf_counter() - t0})

    # ---- 12. the scenario engine, float64 and float32 ----------------------
    t0 = time.perf_counter()
    launches12 = engine_phase(torch, np, dev)
    emit({"phase": "engine", "launches": launches12,
          "wall_s": time.perf_counter() - t0})
    for rec in kernels:
        if rec["name"] in launches12:
            rec["engine_launches"] = launches12[rec["name"]]

    # ---- 13. class-aggregated planning, float64 -----------------------------
    t0 = time.perf_counter()
    launches13 = classes_phase(torch, np, dev)
    emit({"phase": "classes", "launches": launches13,
          "wall_s": time.perf_counter() - t0})

    # ---- 14. robustness, fleet planning at D = 1, admission, float64 -------
    t0 = time.perf_counter()
    launches14 = robust_phase(torch, np, dev, quickstart=sched,
                              hetero_fleet=hetero_fleet)
    emit({"phase": "robust", "launches": launches14,
          "wall_s": time.perf_counter() - t0})

    # ---- 15. the streaming control plane and the fleet's streams ------------
    t0 = time.perf_counter()
    launches15 = stream_phase(torch, np, dev)
    emit({"phase": "stream", "launches": launches15,
          "wall_s": time.perf_counter() - t0})

    # ---- 16. the cluster scheduler; Mamba serving through K4 ---------------
    t0 = time.perf_counter()
    launches16 = cluster_phase(torch, np, dev)
    emit({"phase": "cluster", "launches": launches16,
          "wall_s": time.perf_counter() - t0})
    t0 = time.perf_counter()
    mamba = mamba_phase(torch, np, dev)
    emit({"phase": "mamba", "wall_s": time.perf_counter() - t0})
    for rec in kernels:
        if rec["name"] == "linear_scan":
            rec["mamba_path"] = mamba

    # ---- 17. MoE, the VLM prefix, the encoder–decoder through K5 ---------
    t0 = time.perf_counter()
    launches17, moe_k5 = new_paths_phase(torch, np, dev)
    emit({"phase": "new_paths", "launches": launches17,
          "wall_s": time.perf_counter() - t0})
    for rec in kernels:
        if rec["name"] == "flash_attention":
            rec["new_paths_launches"] = launches17
            rec["moe_shape"] = {k: moe_k5[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "kernel_device_ms", "max_abs_err", "shape")}

    # ---- 18. training llama3.2-1b through K5 and K5's backward ------------
    t0 = time.perf_counter()
    launches18, bwd_rec, k5_train = train_phase(torch, np, dev)
    emit({"phase": "train", "launches": launches18,
          "wall_s": time.perf_counter() - t0})
    for rec in kernels:
        if rec["name"] == "flash_attention":
            rec["train"] = k5_train
    kernels.append(bwd_rec)

    # ---- 19. training recurrentgemma and Mamba through K4's backward -----
    t0 = time.perf_counter()
    launches19, k4_bwd_rec, k5_hd256 = scan_train_phase(torch, np, dev)
    emit({"phase": "train_scan", "launches": launches19,
          "wall_s": time.perf_counter() - t0})
    bwd_rec["hd256_shape"] = k5_hd256
    kernels.append(k4_bwd_rec)

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
