"""Rehearse chip_smoke.py's phase 20 (training the MoE, the VLM and the
encoder–decoder; the launcher under each policy) on the CPU at toy
sizes, and count the peak memory of its MoE step at the real shapes.

    PYTHONPATH=src python tools/phase20_rehearse.py [--count-only]

First it prints the count that sets ``NEW_TRAIN_LAYERS``: the training
step's peak for qwen2-moe-a2.7b at 3 and 4 of its 24 layers and for
dbrx-132b at one of its 40, at full width, 4 × 4096 tokens in 2
micro-batches under remat "full" (``peak_count``).  Then it runs
``chip_smoke.new_train_phase`` on the CPU with phase 18's stand-ins
(``tools/phase18_rehearse.py``: K5's plain versions counted as the
kernels are, fake CUDA events, memory statistics and profiler, the
smoke configs in bf16, sequences of 64 tokens), so every check of the
phase runs on that path: the captures, the launch counts, the routes
and their recompute, the end-to-end floors, the policies.  Its numbers
are no measurement of anything.  About a minute on an 8-core CPU.
"""
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
import phase18_rehearse as p18  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.moe import capacity  # noqa: E402
from repro_torch.models.transformer import Transformer  # noqa: E402

GB = 1e9


def peak_count(cfg, batch=cs.NEW_TRAIN_BATCH, seq=cs.TRAIN_SEQ,
               micro=cs.NEW_TRAIN_MICRO):
    """The bytes a training step of ``cfg`` holds at its peak, by part.

    The step's state is 24 B a parameter at the second micro-batch's
    backward: the f32 master, both AdamW moments and the first
    micro-batch's f32 gradients (4 B each), the bf16 cast copy and its
    bf16 gradients (2 each) and their f32 cast (4).  Beside it: each
    layer's bf16 input, which remat "full" keeps; one layer recomputed in
    the backward pass (its attention's q, k, v, o and the log-sum-exp;
    a MoE layer's dispatch and combine one-hots of one chunk of groups in
    f32 and bf16 with one f32 product of a choice, the experts' rows in,
    their gate, up and product, and out, the shared experts' three
    activations; the dense MLP's); one cross-entropy chunk's logits in
    bf16 and f32 and their gradient.  After the backward, AdamW holds the
    masters, moments and summed gradients (16 B a parameter) and about
    ten f32 temporaries of its largest leaf."""
    model = Transformer(cfg, device="meta", dtype=torch.float32)
    params = {n: p.numel() for n, p in model.named_parameters()}
    P = sum(params.values())
    mb, d, bf16 = batch // micro, cfg.d_model, 2
    rows = mb * seq
    part = {"state_24B": 24 * P,
            "layer_inputs": cfg.n_layers * rows * d * bf16}
    attn = rows * cfg.head_dim * (2 * cfg.n_heads + 2 * cfg.n_kv_heads)
    layer = attn * bf16 + 4 * mb * cfg.n_heads * seq
    moe = {}
    if cfg.moe:
        G = min(cfg.moe_group_size, rows)
        n = -(-rows // G)
        mg = min(n, cfg.moe_parallel_groups)
        C = capacity(cfg, G)
        E, f = cfg.n_experts, cfg.d_ff_expert
        moe = {"onehots": mg * G * E * C * (2 * 4 + 2 * bf16 + 4),
               "expert_rows": E * mg * C * (2 * d + 3 * f) * bf16,
               "shared": 3 * rows * f * cfg.n_shared_experts * bf16}
        layer += sum(moe.values())
    else:
        layer += 3 * rows * cfg.d_ff * bf16
    part["one_layer_recomputed"] = layer
    part["ce_chunk"] = mb * cfg.ce_chunk * cfg.vocab * (bf16 + 4 + 4)
    backward = sum(part.values())     # the layer and the chunk, both
    largest = max(params.values())
    adamw = 16 * P + 10 * 4 * largest
    return {"arch": cfg.name, "layers": cfg.n_layers, "params": P,
            "largest_leaf": largest,
            "parts_gb": {k: v / GB for k, v in part.items()},
            "moe_layer_gb": {k: v / GB for k, v in moe.items()},
            "backward_peak_gb": backward / GB, "adamw_peak_gb": adamw / GB,
            "peak_gb": max(backward, adamw) / GB}


def counts():
    out = [peak_count(get_config(cs.MOE_ARCH).replace(n_layers=n))
           for n in (3, 4)]
    out.append(peak_count(get_config(cs.DBRX_ARCH).replace(n_layers=1)))
    for c in out:
        c["fits_76_gb"] = c["peak_gb"] <= 76.0
    moe = get_config(cs.MOE_ARCH)
    G = moe.moe_group_size
    out.append({"qwen2-moe dispatch": {
        "group": G, "experts": moe.n_experts, "capacity": capacity(moe, G),
        "groups_a_microbatch": cs.NEW_TRAIN_BATCH // cs.NEW_TRAIN_MICRO
        * cs.TRAIN_SEQ // G}})
    return out


def main():
    print(json.dumps({"peak_count": counts()}, indent=1))
    if "--count-only" in sys.argv:
        return
    real = {a: cs.train_launches(cs.new_train_config(a), cs.TRAIN_SEQ,
                                 cs.NEW_TRAIN_MICRO)
            for a in cs.NEW_TRAIN_ARCHS}
    p18.install()
    # at the smoke width the launcher's warm-up moves the loss by ~1e-3,
    # which the last step may not lower: a faster warm-up here
    cs.TRAIN_OPT = {"lr": 3e-2, "warmup_steps": 2}
    launches, figs, recs = cs.new_train_phase(torch, np, torch.device("cpu"))
    print(json.dumps({"launches_a_step_at_the_real_shapes": real}))
    print({"launches": launches, "figures": figs,
           "k5_bwd_cases": sorted(recs)})


if __name__ == "__main__":
    main()
