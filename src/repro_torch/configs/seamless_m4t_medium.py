"""seamless-m4t-medium [audio] — enc-dec 12L+12L d=1024 16H d_ff=4096
vocab=256206; speech frontend STUBBED: input_specs feeds precomputed frame
embeddings. [arXiv:2308.11596; hf]"""
from .base import ModelConfig


def full_config():
    return ModelConfig(
        name="seamless-m4t-medium", family="audio",
        n_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, head_dim=64,
        d_ff=4096, vocab=256206, encoder_decoder=True, n_enc_layers=12,
        frontend="audio", patch_dim=1024,
    )


def smoke_config():
    return full_config().replace(
        n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        head_dim=16, d_ff=128, vocab=512, patch_dim=32,
        dtype="float32", scan_chunk=32,
    )
