"""Serve launcher: batched prefill + decode over several request waves.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
        --batch 4 --prompt-len 64 --gen 32 [--requests 3] [--device cpu]

Runs the architecture's smoke config with random weights from seed 0, as
the JAX launcher does (MoE through its dense path; the VLM gets random
patches and the encoder–decoder random frames of the prompt's length);
on CUDA unless ``--device`` says otherwise.  Every config the repo ships
serves.  The caches hold n_patches + prompt + gen positions: the JAX
launcher sizes them at prompt + gen and drops the VLM's last writes,
which the port refuses.  ``chip_smoke.py`` drives the full configs on
the card.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .._device import resolve_device
from ..configs import get_config
from ..models import init_params
from ..serve import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--requests", type=int, default=3)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, smoke=True)
    if cfg.moe:
        cfg = cfg.replace(moe_impl="dense")
    dev = resolve_device(args.device)
    model = init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                        device=dev)
    n_prefix = cfg.n_patches if cfg.family == "vlm" else 0
    eng = ServeEngine(model=model,
                      max_len=n_prefix + args.prompt_len + args.gen,
                      temperature=args.temperature)

    rng = np.random.default_rng(0)
    total_tok, total_s = 0, 0.0
    for r in range(args.requests):
        batch = {"tokens": rng.integers(
            2, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32)}
        if cfg.family == "vlm":
            batch["patches"] = rng.standard_normal(
                (args.batch, cfg.n_patches, cfg.patch_dim)).astype(np.float32)
        if cfg.encoder_decoder:
            batch["frames"] = rng.standard_normal(
                (args.batch, args.prompt_len, cfg.patch_dim)).astype(np.float32)
        t0 = time.perf_counter()
        out = eng.generate(batch, args.gen)
        dt = time.perf_counter() - t0
        total_tok += out.size
        total_s += dt
        print(f"request wave {r}: {out.shape} in {dt:.2f}s")
    print(f"served {total_tok} tokens at {total_tok / total_s:.1f} tok/s "
          f"on {model.device}")
    return out


if __name__ == "__main__":
    main()
