#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card and check what comes out.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (each one is a check; any failure exits non-zero):
  1. the card: CUDA must be available; prints name and power limit;
  2. the build: nvcc builds the kernels from src/repro_torch/**/csrc;
  3. the batched CAP front door at full width (N = 256 tenants ×
     k = 4096 jobs, float32): ``solve_cap_batched(impl="auto")`` with a
     shared shifted power (CUDA kernel generic_waterfill) and a per-job
     power/log/saturating mix (hetero_waterfill);
  4. the level WFP: ``gwf_waterfill_op`` at k = 4096 with 25% inactive
     bottles (gwf_waterfill).
     Phases 3–4 hold each kernel against its plain version (and K1, K3
     against the float64 closed form) per row in units of the mean
     allocation, check the KKT conditions (K1, K2) or the common level
     and budget (K3), and show that planted faults fail those checks;
  5. planning on the card in float64: the quickstart instance, the
     batched-planning instance, and ``smartfill_batched`` at N = 256,
     M = 32 against the port's own CPU run;
  6. times: each kernel and its plain version (CUDA events, median of
     25 after a warm-up) and the wall time of each planning phase.

Launch counters are reset before phases 3–4 drive the main path and
read right after; the comparisons and timings come later and do not
count.  Prints one JSON line per measurement, the kernel summary line
``{"kernels": [...]}``, the card line, and last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
CU = "src/repro_torch/kernels/gwf_waterfill/csrc/gwf_waterfill.cu"
TPU_KERNELS = "src/repro/kernels/gwf_waterfill/kernel.py"

N, K = 256, 4096          # tenants × jobs of the batched front door
B = 10.0
ITERS = 64
# H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and FP32 (non-tensor)
# operations/s.  Each transcendental counts as one FP32 operation, so the
# operation bound is a floor.
HBM_BPS = 3.35e12
FP32_OPS = 67e12


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


def bound(nbytes, nops):
    t_bytes = nbytes / HBM_BPS * 1e3
    t_ops = nops / FP32_OPS * 1e3
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
    h0_i ≥ h."""
    import torch
    th, u, h0 = theta.double(), u.double(), h0.double()
    active = u > 0
    pos = interior(th, active, b)
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


def main():
    if not (SRC / "repro_torch").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    import numpy as np
    import torch

    # ---- 1. the card ------------------------------------------------------
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    dev = torch.device("cuda")
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
    ptxas = [ln.strip() for rep in reports.values()
             for ln in rep.splitlines() if "registers" in ln or "spill" in ln]
    emit({"phase": "build", "seconds": build_s, "sources": sorted(reports),
          "ptxas": ptxas})

    # ---- inputs, made from a seed -----------------------------------------
    rng = np.random.default_rng(0)
    C = np.zeros((N, K))
    for n in range(N):
        k = int(rng.integers(K // 2, K + 1))
        C[n, :k] = np.sort(rng.uniform(0.01, 1.0, k))[::-1]
    b = np.linspace(1.0, 40.0, N)
    fam = rng.integers(0, 3, (N, K))              # 0 power, 1 log, 2 satur.
    a_ = rng.uniform(0.5, 2.0, (N, K))
    p_pow = rng.uniform(0.3, 0.8, (N, K))
    p_log = rng.uniform(0.5, 2.0, (N, K))
    p_sat = rng.uniform(1.5, 3.0, (N, K))
    z_sat = rng.uniform(40.0, 80.0, (N, K))       # z ≥ the largest budget
    A_mix = np.where(fam == 0, a_ * p_pow, np.where(fam == 1, a_,
                                                    a_ * p_sat))
    w_mix = np.where(fam == 0, 0.0, np.where(fam == 1, 1.0 / p_log, z_sat))
    g_mix = np.where(fam == 0, p_pow - 1.0, np.where(fam == 1, -1.0,
                                                     p_sat - 1.0))
    s_mix = np.where(fam == 2, -1.0, 1.0)
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
    sp3 = shifted_power(1.0, 4.0, 0.5, B, device=dev, dtype=torch.float32)
    c3d = torch.tensor(c3, dtype=torch.float32, device=dev)
    act3 = torch.arange(K, device=dev) < m3
    u3 = torch.where(act3, sp3.bottle_width(c3d), 0.0).contiguous()
    h3 = torch.where(act3, sp3.bottle_bottom(c3d), 0.0).contiguous()
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
    emit({"phase": "level_wfp", "K3_vs_plain": err3,
          "K3_vs_closed_f64": err3c,
          "limits": {"alloc": ALLOC_LIMIT["K3"], "level": KKT_LIMIT,
                     "sum": SUM_LIMIT}, "readings": readings3})

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
    # 1/γ) plus 20 in its bracket pass; K3 5 (sub, mul, max, min, add).
    calls = {
        "generic_waterfill": (
            151, lambda impl: ops.generic_waterfill_op(
                Cd, Af, wf, gf, bd, iters=ITERS, impl=impl),
            err1, 4 * (2 * N * K + 8 * N), (ITERS + 1) * n_act * 12),
        "hetero_waterfill": (
            257, lambda impl: ops.hetero_waterfill_op(
                Cd, *mix32, bd, iters=ITERS, impl=impl),
            err2, 4 * (6 * N * K + N), ((ITERS + 1) * 14 + 20) * n_act),
        "gwf_waterfill": (
            82, lambda impl: ops.gwf_waterfill_op(u3, h3, b3, iters=ITERS,
                                                  impl=impl),
            err3, 4 * 3 * K, ITERS * m3 * 5),
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
    # wrapper's own small PyTorch kernels (K1's λ-bracket, the casts).
    # Averaged per launch of the kernel, so a trace that drops events
    # still gives per-call figures.
    split = {}
    for name, (_, op, *_) in calls.items():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                op("cuda")
            torch.cuda.synchronize()
        on_dev = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        mine = [e for e in on_dev if f"{name}_kernel" in e.key]
        n = sum(e.count for e in mine)
        check(n > 0, f"the profiler saw no {name} kernel on the device")
        t_mine = sum(e.device_time_total for e in mine) / 1e3
        t_all = sum(e.device_time_total for e in on_dev) / 1e3
        split[name] = {"traced_launches": n, "kernel_device_ms": t_mine / n,
                       "other_device_ms": (t_all - t_mine) / n,
                       "device_kernels_per_call":
                           sum(e.count for e in on_dev) / n}
    emit({"phase": "profile", **split})

    print(json.dumps({"kernels": kernels}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
