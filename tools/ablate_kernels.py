#!/usr/bin/env python3
"""Where the time of K5 (flash attention, bf16), K5's backward (bf16, the
wgmma kernels), K4 (linear scan, f32), K1 and K2 (the batched CAP
water-fills, f32) and K3 (the level WFP, f32) goes on the card, at the
main path's shapes.

Run from the root of a checkout on a machine with one CUDA card and nvcc:

    python3 tools/ablate_kernels.py [GROUP ...]

where a GROUP (a key of ``VARIANTS``: flash_attention,
flash_attention_bwd, linear_scan, gwf_waterfill for K1/K2, K3) limits the
run to those kernels' variants.

It needs no hardware profiler: it takes parts out instead.  Each
variant is a kernel's source with one statement replaced (``VARIANTS``),
built with the same nvcc command as the kernel (K1 and K2's variants
print their registers and spills), and timed with CUDA
events beside the whole kernel, in two interleaved rounds.  A variant's
output is wrong by design; only its time counts.  A replacement that no
longer matches the source raises.  K4's yardstick is ``torch.add`` over
the same bytes (a and b read, one array written).  K1 and K2 run at
chip_smoke.py's phase-3 instance (256 × 4096) at each block size they
are built for (256, 512, 1024); their variants that change only how t
is rounded (``PRECISION``) also print their readings, at kernel.py's
block size, against the plain version and against the plain version in
float64, in units of b/k_act.  K3 runs at chip_smoke.py's phase-4
instance (4096 bottles, 3072 active) at each block size: whole (two
bits a round), without its fixed-point exit (all 64 bits), without the
round's reduction (and without the exit, to compare with that), as
plain bisection (one bit a round) and with three bits a round, with the
warps' posts summed by every thread in turn rather than by a butterfly,
with the register tile's bottles in shared memory, without any round
(the first pass, bracket and write alone), and as an empty kernel (the
launch's floor); the variants without the exit, with one or three bits
a round and with the bottles in shared memory must give the whole
kernel's bits at each block size, or the tool fails.
K3's rows also carry the kernel's device time from the profiler
(``device_ms``): an event-timed call of K3 is mostly the host's launch.
K5's backward runs at llama3.2-1b's training shape (4, 4096, 32:8, 64),
causal (the instantiation of 64 columns), and at recurrentgemma-2b's
local layer (2, 4096, 10:1, 256), causal with a window of 2048 (that of
256 columns), each with the geometry ``kernel.bwd_geometry`` gives it
(``shape`` in its rows); its rows carry each kernel's device time
(``device_ms_dq``, ``device_ms_dkdv``):
whole, without the exponentials (ex2 replaced by a copy), without the
dQ kernel's D pass (its tiles waited for and handed back, nothing
computed), and with the products of a warpgroup serialised against the
elementwise work (P formed after both S and dP are in; in dK/dV also
dS after dV += Pᵀ·dO is in; the dQ product kept in flight over the
next tile's start as in the whole kernel).
Prints one JSON line per variant and round, then the card's name and
power limit.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import numpy as np  # noqa: E402

from chip_smoke import (ITERS, alloc_err, cap_instance, card_line,  # noqa: E402
                        kkt_residual, level_bottles, timed)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fk  # noqa: E402
from repro_torch.kernels.gwf_waterfill import kernel as wk  # noqa: E402
from repro_torch.kernels.gwf_waterfill import ref as wr  # noqa: E402
from repro_torch.kernels.linear_scan.kernel import scan_geometry  # noqa: E402

_EXP2 = "  const float e = exp2_ftz(t);"
_NO_LO = ("  const float t = fmaf(ginv, u, bhi) + blo;",
          "  const float t = fmaf(ginv, u, bhi);")
_NO_RECENTRE = [("    if (it == kRecentre) {", "    if (it < 0) {"),
                ("streamed(j, it >= kRecentre)", "streamed(j, false)"),
                ("  const bool moved = iters > kRecentre;",
                 "  const bool moved = false;")]
_DOUBLE_MOVE = ("  bhi = fmaf(ginv, Lc, bhi) + blo;\n  blo = 0.0f;",
                "  const Pair p = split(static_cast<double>(bhi) + blo +\n"
                "                       static_cast<double>(ginv) * Lc);\n"
                "  bhi = p.hi;\n  blo = p.lo;")
# source: {variant: [(statement, replacement), ...]}
VARIANTS = {
    "flash_attention": {
        "whole": [],
        "no_kv_loads_in_loop": [
            ("      if (kt < walk.kt_hi) load_kv(kt + 1, stage ^ 1);", ""),
            ("    if (tma) mbar_wait(&bars[stage], (i >> 1) & 1);",
             "    if (tma && i == 0) mbar_wait(&bars[0], 0);"),
            ("    const T* Ks = KVs + stage * 2 * kTile;",
             "    const T* Ks = KVs;")],
        "no_softmax": [
            ("      softmax_tile(s, m, l, alpha);",
             "      alpha[0] = alpha[1] = 1.0f;")],
        "no_mask": [
            ("      mask_scores(s, qr, k0 + kc, T_len, causal, window, cap,\n"
             "                  tile_open_for_warp(r0, k0, T_len, causal, "
             "window));", "")],
        "no_qk": [
            ("      Products<T, HD>::qk(s, Qs, Ks, warp, lane);",
             "      for (int j = 0; j < kNT; ++j)\n"
             "        for (int e = 0; e < 4; ++e) s[j][e] = 0.01f * (j + e);")],
        "no_pv": [
            ("      Products<T, HD>::pv(acc, s, Ks + kTile, warp, lane);",
             "      acc[0][0] += s[0][0];")],
        "no_rescale": [
            ("        acc[n][0] *= alpha[0];\n        acc[n][1] *= alpha[0];\n"
             "        acc[n][2] *= alpha[1];\n        acc[n][3] *= alpha[1];",
             "")],
    },
    "flash_attention_bwd": {
        "whole": [],
        "no_exp2": [('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));',
                     "  y = x;")],
        "no_d_pass": [("      const bool go = !pairs_closed(o, r_wg, r_wg + 63, "
                       "k0, k0 + kKeys - 1);",
                       "      const bool go = false;")],
        "serial_products": [
            ("      if (!cap) {\n        wgmma_wait<1>();",
             "      if (!cap) {\n        wgmma_wait<0>();"),
            ("            wgmma_wait<1>();\n            hold(sT);",
             "            wgmma_wait<0>();\n            hold(sT);"),
            ("            wgmma_wait<1>();                      // dPᵀ is in",
             "            wgmma_wait<0>();")],
    },
    "linear_scan": {
        "whole": [],
        "no_look_back": [("  if (chunk > 0) {\n    if (live) {",
                          "  if (chunk < 0) {\n    if (live) {")],
    },
    # K1 and K2 share these statements
    "gwf_waterfill": {
        "whole": [],
        "no_exp2": [(_EXP2, "  const float e = t;")],
        "no_reduction": [("    s = red.sum(s);",
                          "    s = s * 1e-30f + ((it & 1) ? 2.0f * b : 0.0f);")],
        "no_steps": [("  for (int it = 0; it < iters; ++it) {\n"
                      "    if (it == kRecentre) {",
                      "  for (int it = 0; it < 0; ++it) {\n"
                      "    if (it == kRecentre) {")],
        "exp2f": [(_EXP2, "  const float e = exp2f(t);")],
        "no_lo_word": [_NO_LO],
        "no_recentre": _NO_RECENTRE,
        "double_move": [_DOUBLE_MOVE],
    },
}
_NO_EXIT = ("    if (fixed) break;   // every later step leaves (lo, hi) "
            "as they are\n", "")
_K3_FIRST = ("  constexpr int kJobs = kTileJobs / NT;        "
             "// register-tile bottles")
VARIANTS["K3"] = {     # K3's statements, in the same source as K1 and K2
    "whole": [],
    "no_exit": [_NO_EXIT],
    "no_reduction_no_exit": [
        ("    sums.fold(s);",
         "    for (int n = 0; n < L; ++n)\n"
         "      s[n] = s[n] * 1e-30f + ((it & 1) ? 2.0f * b : 0.0f);"),
        _NO_EXIT],
    "bisection_r1": [("constexpr int kLevelBits = 2;",
                      "constexpr int kLevelBits = 1;")],
    "multisection_r3": [("constexpr int kLevelBits = 2;",
                         "constexpr int kLevelBits = 3;")],
    "broadcast_fold": [
        ("      s[n] = warp_sum(lane < NT / 32 ? p[n][lane] : 0.0f);",
         "    {\n      float t = 0.0f;\n#pragma unroll\n"
         "      for (int w = 0; w < NT / 32; ++w) t += p[n][w];\n"
         "      s[n] = t;\n    }")],
    "no_steps": [("  for (int it = 0; it < iters;) {",
                  "  for (int it = 0; it < 0;) {")],
    "bottles_in_smem": [
        ("""  float ru[kJobs], rh[kJobs];
#pragma unroll
  for (int k = 0; k < kJobs; ++k) {
    const int j = tid + k * NT;
    const float2 q = j < M ? first(j) : make_float2(0.0f, 0.0f);
    ru[k] = q.x;
    rh[k] = q.y;
  }
""",
         """  __shared__ float2 stage[kTileJobs];
#pragma unroll 1
  for (int j = tid; j < M && j < kTileJobs; j += NT) stage[j] = first(j);
"""),
        ("""#pragma unroll
    for (int k = 0; k < kJobs; ++k)
      if (k * NT < M) add(ru[k], rh[k]);
""",
         """#pragma unroll 1
    for (int j = tid; j < M && j < kTileJobs; j += NT) {
      const float2 q = stage[j];
      add(q.x, q.y);
    }
"""),
        ("""#pragma unroll
  for (int k = 0; k < kJobs; ++k) {
    const int j = tid + k * NT;
    if (j < M) theta[j] = level_theta(ru[k], rh[k]);
  }
""",
         """#pragma unroll 1
  for (int j = tid; j < M && j < kTileJobs; j += NT)
    theta[j] = level_theta(stage[j].x, stage[j].y);
""")],
    "empty": [(_K3_FIRST, "  return;\n" + _K3_FIRST)],
}
SOURCE = {"K3": "gwf_waterfill"}
# the variants of K1 and K2 that only round t otherwise: their readings
PRECISION = ("whole", "exp2f", "no_lo_word", "no_recentre", "double_move")
# the K3 variants that must give the whole kernel's bits
K3_EXACT = ("no_exit", "bisection_r1", "multisection_r3", "bottles_in_smem")
CAP = ("generic_waterfill", "hetero_waterfill")


# K5's backward: llama3.2-1b's training shape (the instantiation of 64
# columns) and recurrentgemma-2b's local layer (256 columns, its window):
# (B, S, H, K, hd, window), causal
BWD_SHAPES = {"llama_hd64": (4, 4096, 32, 8, 64, None),
              "rg_local_hd256": (2, 4096, 10, 1, 256, 2048)}


def build(out: Path, groups) -> dict:
    """Every variant's library of ``groups``, built at once:
    {(kernel, variant): path}."""
    nvcc = _build.find_nvcc()
    procs = {}
    for kernel in groups:
        variants = VARIANTS[kernel]
        src = _build.SOURCES[SOURCE.get(kernel, kernel)].read_text()
        for name, subs in variants.items():
            text = src
            for old, new in subs:
                if text.count(old) != 1:
                    raise RuntimeError(f"{kernel}/{name}: the statement to "
                                       f"replace is not in the source once")
                text = text.replace(old, new)
            cu = out / f"{kernel}-{name}.cu"
            cu.write_text(text)
            lib = cu.with_suffix(".so")
            # the copy finds its quoted headers beside the original
            cmd = [nvcc, *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                   "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                   "-I", str(_build.SOURCES[SOURCE.get(kernel, kernel)].parent),
                   "-o", str(lib), str(cu)]
            procs[kernel, name] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{key}: nvcc failed\n{log}")
        libs[key] = lib
        if key[0] in ("gwf_waterfill", "K3"):
            usage = {_build.kernel_label(fn): u for fn, u in
                     _build.ptxas_usage(log).items() if "waterfill_kernel<"
                     in _build.kernel_label(fn)}
            print(json.dumps({"kernel": key[0], "variant": key[1],
                              "ptxas": usage}), flush=True)
    return libs


class CapCalls:
    """K1 and K2 on chip_smoke.py's phase-3 instance (256 × 4096 jobs),
    called through a variant library's C entry points with the arguments
    kernel.py passes, at each block size; and their readings."""

    def __init__(self, dev):
        rng = np.random.default_rng(0)
        C, b, mix = cap_instance(rng, 256, 4096, 1.0, 40.0)
        self.c = torch.tensor(C, dtype=torch.float32, device=dev)
        self.b = torch.tensor(b, dtype=torch.float32, device=dev)
        self.mix = [torch.tensor(x, dtype=torch.float32, device=dev)
                    for x in mix]
        # phase 3's shared family: shifted_power(1, 4, 0.5)
        self.shared = [torch.tensor(x, device=dev).expand(256)
                       for x in (0.5, 4.0, -0.5)]
        self.scale = self.b.double() / (self.c > 0).sum(1).double()
        self.plain, self.plain64, self.fam = {}, {}, {}
        one = torch.ones(1, 1, device=dev)
        for name, fn, args in (
                ("generic_waterfill", wr.generic_waterfill_ref,
                 self.shared),
                ("hetero_waterfill", wr.hetero_waterfill_ref, self.mix)):
            self.plain[name] = fn(self.c, *args, self.b, iters=ITERS)
            self.plain64[name] = fn(self.c.double(),
                                    *[x.double() for x in args],
                                    self.b.double(), iters=200)
            self.fam[name] = ((self.c, *[x[:, None] for x in args], one,
                               self.b) if name == "generic_waterfill" else
                              (self.c, *args, self.b))

    def bind(self, lib, variant):
        P, I = ctypes.c_void_p, ctypes.c_int
        stream = P(torch.cuda.current_stream().cuda_stream)
        N, K = self.c.shape
        cf, vals = wk.generic_args(self.c, *self.shared, self.b)
        calls = {}
        for threads in (256, 512, 1024):
            for name in CAP:
                entry = f"{name}_f32"
                fn = getattr(lib, entry)
                fn.argtypes = [*wk._SIGNATURES[entry], P]
                fn.restype = I
                out = torch.empty_like(self.c)
                tiles = wk.job_tiles(K, threads, wk.FIELDS[name])
                if name == "generic_waterfill":
                    args = (P(cf.data_ptr()),
                            *[a for t, st in vals
                              for a in (P(t.data_ptr()), st)],
                            P(out.data_ptr()), N, K, ITERS, 1, threads,
                            tiles.smem_jobs, stream)
                else:
                    args = (*[P(x.data_ptr()) for x in (self.c, *self.mix,
                                                        self.b, out)],
                            N, K, ITERS, threads, tiles.smem_jobs, stream)
                calls[name, variant, threads] = (fn, args, None, out)
        return calls

    def readings(self, name, out):
        r = {"alloc_vs_plain": alloc_err(out, self.plain[name], self.scale),
             "alloc_vs_plain_f64": alloc_err(out, self.plain64[name],
                                             self.scale),
             "plain_vs_plain_f64": alloc_err(self.plain[name],
                                             self.plain64[name], self.scale)}
        r["kkt_spread"], r["kkt_park"] = kkt_residual(out, *self.fam[name])
        return r


class LevelCalls:
    """K3 on chip_smoke.py's phase-4 instance, called through a variant
    library's C entry point with the arguments kernel.py passes, at each
    block size."""

    def __init__(self, dev):
        rng = np.random.default_rng(0)
        cap_instance(rng, 256, 4096, 1.0, 40.0)      # phase 4's draws follow
        c3 = np.sort(rng.uniform(0.01, 1.0, 4096))[::-1].copy()
        _, self.u, self.h0 = level_bottles(torch, c3, dev)
        self.b = 200.0

    def bind(self, lib, variant):
        P, I = ctypes.c_void_p, ctypes.c_int
        stream = P(torch.cuda.current_stream().cuda_stream)
        M = self.u.shape[0]
        fn = lib.gwf_waterfill_f32
        fn.argtypes = [*wk._SIGNATURES["gwf_waterfill_f32"], P]
        fn.restype = I
        calls = {}
        for threads in (256, 512, 1024):
            out = torch.empty_like(self.u)
            tiles = wk.job_tiles(M, threads, wk.FIELDS["gwf_waterfill"])
            args = (P(self.u.data_ptr()), P(self.h0.data_ptr()),
                    ctypes.c_float(self.b), P(out.data_ptr()), M, ITERS,
                    threads, tiles.smem_jobs, stream)
            calls["gwf_waterfill", variant, threads] = (fn, args, None, out)
        return calls


def device_ms(fn, kernel):
    """Mean device ms of the kernels named ``kernel`` over a profiled run
    of ten calls of ``fn`` (the profiler keeps some launches of a
    repeated kernel, once none: up to three tries), or None."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                fn()
            torch.cuda.synchronize()
        mine = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and kernel in e.key]
        n = sum(e.count for e in mine)
        if n:
            return sum(e.device_time_total for e in mine) / 1e3 / n
    return None


def main():
    if not torch.cuda.is_available():
        sys.exit("tools/ablate_kernels.py: no CUDA card")
    groups = sys.argv[1:] or list(VARIANTS)
    unknown = set(groups) - set(VARIANTS)
    if unknown:
        sys.exit(f"tools/ablate_kernels.py: no variants of {sorted(unknown)}; "
                 f"choose from {sorted(VARIANTS)}")
    out = _build.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    libs = build(out, groups)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    P, I = ctypes.c_void_p, ctypes.c_int
    stream = P(torch.cuda.current_stream().cuda_stream)

    # K5 at the serving shape: q (2, 4096, 10, 256), kv (2, 4096, 1, 256)
    q = (torch.randn(2, 4096, 10, 256, generator=gen, device=dev)
         * 256 ** -0.5).bfloat16()
    k = torch.randn(2, 4096, 1, 256, generator=gen, device=dev).bfloat16()
    v = torch.randn(2, 4096, 1, 256, generator=gen, device=dev).bfloat16()
    o = torch.empty_like(q)
    # K4 at the serving shape: a, b (2, 4096, 2560) f32
    B, S, D = 2, 4096, 2560
    a = 0.8 + 0.2 * torch.rand(B, S, D, generator=gen, device=dev)
    b = 0.1 * torch.randn(B, S, D, generator=gen, device=dev)
    y = torch.empty_like(a)
    geo = scan_geometry(B, S, D)
    flags = torch.zeros(geo.flag_ints, dtype=torch.int32, device=dev)
    carry = torch.empty(geo.carry_floats, device=dev)

    keep = []   # the backward's tensors, alive while their pointers are
    # K5's backward at llama3.2-1b's training shape and at
    # recurrentgemma-2b's local layer, bf16: (B, S, H, K, hd, window)
    bwd_args = {}
    for shape, (Bb, Sb, Hb, Kb, hdb, W) in BWD_SHAPES.items():
        qb = (torch.randn(Bb, Sb, Hb, hdb, generator=gen, device=dev)
              * hdb ** -0.5).bfloat16()
        kb, vb = (torch.randn(Bb, Sb, Kb, hdb, generator=gen,
                              device=dev).bfloat16() for _ in range(2))
        dob = torch.randn(Bb, Sb, Hb, hdb, generator=gen,
                          device=dev).bfloat16()
        _, lseb = fk.flash_attention(qb, kb, vb, return_lse=True, window=W)
        ins = (qb, kb, vb, dob, lseb, torch.empty_like(lseb),
               *(torch.empty_like(x) for x in (qb, kb, vb)))
        geo_b = fk.bwd_geometry(Bb, Sb, Sb, Hb, Kb, hdb, torch.bfloat16,
                                True)
        bwd_args[shape] = (
            *[P(t.data_ptr()) for t in ins],
            Bb, Sb, Sb, Hb, Kb, hdb, 1, W or 0, ctypes.c_float(0.0),
            int(geo_b.route == "wgmma"), *geo_b[1:], stream)
        keep.append(ins)

    cap = CapCalls(dev)
    level = LevelCalls(dev)
    calls = {}
    for (kernel, name), lib in libs.items():
        if kernel in ("gwf_waterfill", "K3"):
            bound = cap if kernel == "gwf_waterfill" else level
            calls.update(bound.bind(ctypes.CDLL(str(lib)), name))
            continue
        if kernel == "flash_attention":
            fn = ctypes.CDLL(str(lib)).flash_attention_bf16
            fn.argtypes = [P, P, P, P, *[I] * 8, ctypes.c_float, I, P]
            args = (P(q.data_ptr()), P(k.data_ptr()), P(v.data_ptr()),
                    P(o.data_ptr()), 2, 4096, 4096, 10, 1, 256, 1, 2048,
                    ctypes.c_float(0.0), 1, stream)
            calls[kernel, name] = (fn, args, None)
        elif kernel == "flash_attention_bwd":
            fn = ctypes.CDLL(str(lib)).flash_attention_bwd_bf16
            fn.argtypes = [*fk._BWD_ARGS, P]
            for shape, args in bwd_args.items():
                calls[kernel, name, shape] = (fn, args, None)
        else:  # linear_scan
            fn = ctypes.CDLL(str(lib)).linear_scan_f32
            fn.argtypes = [P, P, P, *[I] * 5, P, P, P]
            args = (P(a.data_ptr()), P(b.data_ptr()), P(y.data_ptr()), B, S,
                    D, 64, 128, P(flags.data_ptr()), P(carry.data_ptr()),
                    stream)
            calls[kernel, name] = (fn, args, flags)
        fn.restype = I

    def run(fn, args, scratch):
        if scratch is not None:
            scratch.zero_()
        err = fn(*args)
        if err != 0:
            raise RuntimeError(f"launch failed with CUDA error {err}")

    for fn, args, scratch, *_ in calls.values():
        run(fn, args, scratch)
    torch.cuda.synchronize()

    for key, out in calls.items():
        if (key[0] in CAP and key[1] in PRECISION
                and key[2] == wk.THREADS[key[0]]):
            print(json.dumps({"kernel": key[0], "variant": key[1],
                              "threads": key[2],
                              **cap.readings(key[0], out[3])}), flush=True)
        if key[0] == "gwf_waterfill" and key[1] in K3_EXACT:
            whole = calls["gwf_waterfill", "whole", key[2]][3]
            same = torch.equal(out[3].view(torch.int32),
                               whole.view(torch.int32))
            print(json.dumps({"kernel": key[0], "variant": key[1],
                              "threads": key[2],
                              "bits_equal_to_whole": same}), flush=True)
            if not same:
                sys.exit(f"K3 {key[1]} at {key[2]} threads: θ differs from "
                         "the whole kernel's")
    for rnd in range(2):
        for key, (fn, args, scratch, *_) in calls.items():
            ms = timed(torch, lambda: run(fn, args, scratch))
            dev_ms = ({"device_ms": device_ms(lambda: run(fn, args, scratch),
                                              "gwf_waterfill_kernel")}
                      if key[0] == "gwf_waterfill" else {})
            if key[0] == "flash_attention_bwd":
                dev_ms = {f"device_ms_{k}": device_ms(
                    lambda: run(fn, args, scratch),
                    f"flash_attention_bwd_{k}_wgmma_kernel")
                    for k in ("dq", "dkdv")}
            third = "shape" if key[0] == "flash_attention_bwd" else "threads"
            print(json.dumps({"kernel": key[0], "variant": key[1],
                              **({third: key[2]} if len(key) > 2 else {}),
                              "round": rnd, "ms": ms, **dev_ms}), flush=True)
        print(json.dumps({"kernel": "linear_scan", "variant":
                          "torch.add over the same bytes", "round": rnd,
                          "ms": timed(torch, lambda: torch.add(a, b,
                                                               out=y))}),
              flush=True)
        print(json.dumps({"kernel": "linear_scan", "variant":
                          "zeroing the flags alone", "round": rnd,
                          "ms": timed(torch, flags.zero_)}), flush=True)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"sm_clock_now_and_max": clocks}), flush=True)
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()
