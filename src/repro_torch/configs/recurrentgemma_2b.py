"""recurrentgemma-2b [hybrid] — 26L d=2560 10H (MQA kv=1) d_ff=7680
vocab=256000; RG-LRU + local attention, pattern (rglru, rglru, local),
window 2048. [arXiv:2402.19427; hf]"""
from .base import ModelConfig


def full_config():
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
        d_ff=7680, vocab=256000, block_pattern=("rglru", "rglru", "local"),
        window=2048, lru_width=2560, mlp="geglu", tie_embeddings=True,
        embed_scale=True,
        subquadratic=True,
    )


def smoke_config():
    return full_config().replace(
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
        d_ff=128, vocab=512, window=16, lru_width=64,
        dtype="float32", scan_chunk=32,
    )
