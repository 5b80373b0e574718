"""llama3.2-1b [dense] — 16L d=2048 32H (GQA kv=8) d_ff=8192 vocab=128256.
[hf:meta-llama/Llama-3.2-1B; unverified]"""
from .base import ModelConfig


def full_config():
    return ModelConfig(
        name="llama3.2-1b", family="dense",
        n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8, head_dim=64,
        d_ff=8192, vocab=128256, rope_theta=500000.0, mlp="swiglu",
        tie_embeddings=True,
    )


def smoke_config():
    return full_config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, dtype="float32", scan_chunk=32,
    )
