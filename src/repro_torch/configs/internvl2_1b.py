"""internvl2-1b [vlm] — 24L d=896 14H (GQA kv=2) d_ff=4864 vocab=151655;
InternViT frontend STUBBED: input_specs feeds precomputed patch embeddings
(projected in-model). Backbone = Qwen2-0.5B. [arXiv:2404.16821; hf]"""
from .base import ModelConfig


def full_config():
    return ModelConfig(
        name="internvl2-1b", family="vlm",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
        d_ff=4864, vocab=151655, qkv_bias=True, rope_theta=1000000.0,
        frontend="vit", n_patches=256, patch_dim=1024, tie_embeddings=True,
    )


def smoke_config():
    return full_config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, n_patches=8, patch_dim=32,
        dtype="float32", scan_chunk=32,
    )
