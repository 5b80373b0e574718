"""Model/run configuration system.

One ``<arch>.py`` per architecture defines ``full_config()`` (the
published shape) and ``smoke_config()`` (a reduced same-family config
for CPU tests).  ``get_config(arch, smoke=…)`` is the registry entry
point used by ``--arch`` flags.  The same data as the JAX package's
configs; ``compute_dtype`` is a torch dtype here.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

import torch

__all__ = ["ModelConfig", "ShapeConfig", "get_config", "list_archs", "SHAPES",
           "ARCHS", "ALIASES"]

ARCHS = (
    "llama3_2_1b",
    "qwen1_5_4b",
    "gemma2_27b",
    "deepseek_7b",
    "qwen2_moe_a2_7b",
    "dbrx_132b",
    "internvl2_1b",
    "recurrentgemma_2b",
    "seamless_m4t_medium",
    "falcon_mamba_7b",
)

# public ids (paper pool spelling) → module names
ALIASES = {
    "llama3.2-1b": "llama3_2_1b",
    "qwen1.5-4b": "qwen1_5_4b",
    "gemma2-27b": "gemma2_27b",
    "deepseek-7b": "deepseek_7b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "dbrx-132b": "dbrx_132b",
    "internvl2-1b": "internvl2_1b",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "falcon-mamba-7b": "falcon_mamba_7b",
}

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str              # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | vlm | hybrid | audio | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab: int
    block_pattern: tuple = ("attn",)  # cycle of block kinds
    # attention options
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    window: Optional[int] = None
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    local_kv_heads: Optional[int] = None
    post_norm: bool = False
    embed_scale: bool = False
    mlp: str = "swiglu"
    # MoE
    moe: bool = False
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "dispatch"        # dispatch | dense
    moe_group_size: int = 1024
    moe_parallel_groups: int = 256
    # SSM / RG-LRU
    ssm_state: int = 16
    ssm_conv: int = 4
    ssm_expand: int = 2
    dt_rank: int = 0
    ssm_rms_bcdt: bool = False
    lru_width: Optional[int] = None
    # encoder–decoder
    encoder_decoder: bool = False
    n_enc_layers: int = 0
    # modality frontend stubs (precomputed embeddings)
    frontend: Optional[str] = None    # "vit" | "audio"
    n_patches: int = 0
    patch_dim: int = 0
    # numerics / execution
    dtype: str = "bfloat16"
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    scan_chunk: int = 256
    ce_chunk: int = 512
    remat: str = "full"               # none | full | dots
    # sub-quadratic attention? (decides long_500k applicability)
    subquadratic: bool = False

    @property
    def compute_dtype(self) -> torch.dtype:
        try:
            return _DTYPES[self.dtype]
        except KeyError:
            raise ValueError(f"unsupported dtype {self.dtype!r}; "
                             f"one of {sorted(_DTYPES)}") from None

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    @property
    def cycle(self):
        return tuple(self.block_pattern)

    def layer_kinds(self):
        """Expanded per-layer block kinds, length n_layers."""
        cyc = self.cycle
        return tuple(cyc[i % len(cyc)] for i in range(self.n_layers))

    def param_count(self) -> int:
        """Approximate parameter count."""
        d, hd = self.d_model, self.head_dim
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        for kind in self.layer_kinds():
            if kind in ("attn", "local", "bidir"):
                K = self.local_kv_heads if (kind == "local" and self.local_kv_heads) else self.n_kv_heads
                total += d * hd * (self.n_heads + 2 * K) + self.n_heads * hd * d
                if self.moe:
                    total += d * self.n_experts
                    total += self.n_experts * 3 * d * self.d_ff_expert
                    total += 3 * d * self.d_ff_expert * self.n_shared_experts
                elif kind != "mamba":
                    total += 3 * d * self.d_ff
            elif kind == "mamba":
                di = self.ssm_expand * d
                total += d * 2 * di + di * (self.dt_rank + 2 * self.ssm_state)
                total += self.dt_rank * di + di * d + di * self.ssm_state
            elif kind == "rglru":
                w = self.lru_width or d
                total += 2 * d * w + 2 * w * w + w * d
                total += 3 * d * self.d_ff
        if self.encoder_decoder:
            # decoder self+cross attention & FFN per decoder layer
            total += self.n_layers * (
                2 * (d * hd * (self.n_heads + 2 * self.n_kv_heads)
                     + self.n_heads * hd * d) + 3 * d * self.d_ff)
        return int(total)

    def active_param_count(self) -> int:
        """Per-token active params (MoE: top-k + shared only)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        total = self.param_count()
        total -= self.n_layers * self.n_experts * 3 * d * self.d_ff_expert
        total += self.n_layers * self.top_k * 3 * d * self.d_ff_expert
        return int(total)


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    mod_name = ALIASES.get(arch, arch.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {sorted(ALIASES)}")
    mod = importlib.import_module(f"{__package__}.{mod_name}")
    return mod.smoke_config() if smoke else mod.full_config()


def list_archs():
    return list(ALIASES)
