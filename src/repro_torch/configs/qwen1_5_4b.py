"""qwen1.5-4b [dense] — 40L d=2560 20H (GQA kv=20) d_ff=6912 vocab=151936,
QKV bias. [hf:Qwen/Qwen1.5-0.5B; hf]"""
from .base import ModelConfig


def full_config():
    return ModelConfig(
        name="qwen1.5-4b", family="dense",
        n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, head_dim=128,
        d_ff=6912, vocab=151936, qkv_bias=True, rope_theta=5000000.0,
    )


def smoke_config():
    return full_config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=96, vocab=512, dtype="float32", scan_chunk=32,
    )
