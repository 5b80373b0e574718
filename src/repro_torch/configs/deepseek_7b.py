"""deepseek-7b [dense] — 30L d=4096 32H (GQA kv=32 = MHA) d_ff=11008
vocab=102400, llama-arch. [arXiv:2401.02954; hf]"""
from .base import ModelConfig


def full_config():
    return ModelConfig(
        name="deepseek-7b", family="dense",
        n_layers=30, d_model=4096, n_heads=32, n_kv_heads=32, head_dim=128,
        d_ff=11008, vocab=102400, rope_theta=10000.0,
    )


def smoke_config():
    return full_config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512, dtype="float32", scan_chunk=32,
    )
