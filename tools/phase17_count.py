"""How many device operations chip_smoke.py's phase 17 issues, and how
many floating-point operations its prefills need.

    PYTHONPATH=src python tools/phase17_count.py

For each phase-17 model (qwen2-moe-a2.7b at its 24 layers, dbrx-132b at
``chip_smoke.DBRX_LAYERS``, internvl2-1b, seamless-m4t-medium) it counts
the aten operations of one prefill of the phase's batch and of one
decode step at the full config's depth, experts, top-k, groups and
sequence lengths, but narrow widths (d 64, 16-wide heads, 32-wide
experts, vocab 512), in bf16: the count of a layer does not depend on
its widths.  The flash attention op is replaced by a stand-in that
issues what its wrapper issues on the card (the output, then one
kernel), so its calls are counted too.  Each line also gives the
prefill's floating-point operations at the full widths, computed from
the shapes (matrix products, K5's valid (q, k) pairs, the MoE's
dispatch and combine products over every slot), and both at the rates
of PERF.md §5: 12 µs of host time an operation, and the products at 989
TFLOP/s.  No JAX; no timing of the card.  About a minute on an 8-core
CPU.
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

US_PER_OP = 12e-6
BF16_PEAK = 989e12
NARROW = dict(d_model=64, n_heads=4, head_dim=16, d_ff=128, d_ff_expert=32,
              vocab=512, patch_dim=32)


class OpCounter(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += 1
        return func(*args, **(kwargs or {}))


def prefill_flops(cfg, B, S_tok, n_patch, n_frame):
    """Floating-point operations of one prefill at ``cfg``'s widths."""
    from repro_torch.models.moe import capacity
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim

    def attn(N, S, T, causal, self_kv=True):
        proj = 2 * N * d * (2 * H * hd + (2 * K * hd if self_kv else 0))
        pairs = S * (S + 1) // 2 if causal else S * T
        return proj + 4 * B * H * hd * pairs

    def ffn(N):
        if not cfg.moe:
            return 6 * N * d * cfg.d_ff
        E, k = cfg.n_experts, cfg.top_k
        G = min(cfg.moe_group_size, N)
        n = -(-N // G)
        slots = n * E * capacity(cfg, G)
        f = cfg.d_ff_expert
        return (2 * N * d * E + 2 * 2 * n * G * E * capacity(cfg, G) * d
                + 6 * slots * d * f + 6 * N * d * f * cfg.n_shared_experts)

    S = n_patch + S_tok
    N = B * S
    total = n_patch and 2 * B * n_patch * cfg.patch_dim * d
    total += cfg.n_layers * (attn(N, S, S, True) + ffn(N))
    if cfg.encoder_decoder:
        Nf = B * n_frame
        total += 2 * Nf * cfg.patch_dim * d
        total += cfg.n_enc_layers * (attn(Nf, n_frame, n_frame, False)
                                     + ffn(Nf))
        # cross: q and the output over the decoder's tokens, k/v over the
        # frames, every (q, k) pair
        total += cfg.n_layers * (2 * N * d * 2 * H * hd
                                 + 2 * Nf * d * 2 * K * hd
                                 + 4 * B * H * hd * S * n_frame)
    return total + 2 * B * d * cfg.vocab


def count(arch, cfg_full):
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import attention as attn_mod
    from repro_torch.models import decode_step, init_params, prefill

    calls = [0]

    def stand_in(q, k, v, causal=True, window=None, cap=None, impl="auto"):
        calls[0] += 1
        return torch.empty_like(q).copy_(q)      # the kernel: one launch

    attn_mod.flash_attention_op = stand_in
    fk.reset_launches()
    ratio = cfg_full.n_heads // cfg_full.n_kv_heads
    cfg = cfg_full.replace(**NARROW, n_kv_heads=4 // min(ratio, 4),
                           n_patches=cfg_full.n_patches)
    n_tok, n_patch, n_frame = cs.serve_shape(cfg_full)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(2, cfg.vocab, (cs.BATCH, n_tok))}
    if n_patch:
        batch["patches"] = rng.standard_normal(
            (cs.BATCH, n_patch, cfg.patch_dim)).astype(np.float32)
    if n_frame:
        batch["frames"] = rng.standard_normal(
            (cs.BATCH, n_frame, cfg.patch_dim)).astype(np.float32)
    model = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with torch.inference_mode():
        with OpCounter() as c:
            logits, state = prefill(model, batch,
                                    max_len=cs.cache_len(batch))
        n_prefill, k5 = c.n, calls[0]
        tok = logits.argmax(-1)[:, None]
        with OpCounter() as c:
            decode_step(model, tok, state)
    flops = prefill_flops(cfg_full, cs.BATCH, n_tok, n_patch, n_frame)
    print(json.dumps({
        "phase": "phase17_count", "arch": arch, "layers": cfg.n_layers,
        "encoder_layers": cfg.n_enc_layers if cfg.encoder_decoder else 0,
        "tokens": [cs.BATCH, n_tok], "patches": n_patch, "frames": n_frame,
        "prefill_device_ops": n_prefill, "flash_attention_calls": k5,
        "prefill_host_s_at_12us": n_prefill * US_PER_OP,
        "prefill_flops": flops,
        "prefill_ms_at_bf16_peak": flops / BF16_PEAK * 1e3,
        "decode_step_device_ops": c.n,
        "decode_step_host_ms_at_12us": c.n * US_PER_OP * 1e3}), flush=True)


def main():
    from repro_torch.configs import get_config
    for arch, cfg in (
            (cs.MOE_ARCH, get_config(cs.MOE_ARCH)),
            (cs.DBRX_ARCH,
             get_config(cs.DBRX_ARCH).replace(n_layers=cs.DBRX_LAYERS)),
            (cs.VLM_ARCH, get_config(cs.VLM_ARCH)),
            (cs.ENCDEC_ARCH, get_config(cs.ENCDEC_ARCH))):
        count(arch, cfg)


if __name__ == "__main__":
    main()
