#!/usr/bin/env python3
"""Where the time of K5 (flash attention, bf16) and K4 (linear scan, f32)
goes on the card, at the serving path's shapes.

Run from the root of a checkout on a machine with one CUDA card and nvcc:

    python3 tools/ablate_kernels.py

It needs no hardware profiler: it takes parts out instead.  Each
variant is a kernel's source with one statement replaced (``VARIANTS``),
built with the same nvcc command as the kernel, and timed with CUDA
events beside the whole kernel, in two interleaved rounds.  A variant's
output is wrong by design; only its time counts.  A replacement that no
longer matches the source raises.  K4's yardstick is ``torch.add`` over
the same bytes (a and b read, one array written).  Prints one JSON line
per variant and round, then the card's name and power limit.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from chip_smoke import card_line, timed  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.linear_scan.kernel import scan_geometry  # noqa: E402

# kernel: {variant: [(statement, replacement), ...]}
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
    "linear_scan": {
        "whole": [],
        "no_look_back": [("  if (chunk > 0) {\n    if (live) {",
                          "  if (chunk < 0) {\n    if (live) {")],
    },
}


def build(out: Path) -> dict:
    """Every variant's library, built at once: {(kernel, variant): path}."""
    nvcc = _build.find_nvcc()
    procs = {}
    for kernel, variants in VARIANTS.items():
        src = _build.SOURCES[kernel].read_text()
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
            cmd = [nvcc, *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                   "-Xcompiler", "-fPIC", "-o", str(lib), str(cu)]
            procs[kernel, name] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"{key}: nvcc failed\n{log}")
        libs[key] = lib
    return libs


def main():
    if not torch.cuda.is_available():
        sys.exit("tools/ablate_kernels.py: no CUDA card")
    out = _build.BUILD_DIR / "ablation"
    out.mkdir(parents=True, exist_ok=True)
    libs = build(out)
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

    calls = {}
    for (kernel, name), lib in libs.items():
        if kernel == "flash_attention":
            fn = ctypes.CDLL(str(lib)).flash_attention_bf16
            fn.argtypes = [P, P, P, P, *[I] * 8, ctypes.c_float, I, P]
            args = (P(q.data_ptr()), P(k.data_ptr()), P(v.data_ptr()),
                    P(o.data_ptr()), 2, 4096, 4096, 10, 1, 256, 1, 2048,
                    ctypes.c_float(0.0), 1, stream)
            calls[kernel, name] = (fn, args, None)
        else:
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

    for rnd in range(2):
        for (kernel, name), (fn, args, scratch) in calls.items():
            ms = timed(torch, lambda: run(fn, args, scratch))
            print(json.dumps({"kernel": kernel, "variant": name,
                              "round": rnd, "ms": ms}), flush=True)
        print(json.dumps({"kernel": "linear_scan", "variant":
                          "torch.add over the same bytes", "round": rnd,
                          "ms": timed(torch, lambda: torch.add(a, b,
                                                               out=y))}),
              flush=True)
        print(json.dumps({"kernel": "linear_scan", "variant":
                          "zeroing the flags alone", "round": rnd,
                          "ms": timed(torch, flags.zero_)}), flush=True)
    print(card_line(), flush=True)


if __name__ == "__main__":
    main()
