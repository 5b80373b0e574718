"""gemma2-27b [dense] — 46L d=4608 32H (GQA kv=16) d_ff=36864 vocab=256000;
local(4096)/global alternating attention, logit softcaps (attn 50, final 30),
GeGLU. [arXiv:2408.00118; hf]"""
from .base import ModelConfig


def full_config():
    return ModelConfig(
        name="gemma2-27b", family="dense",
        n_layers=46, d_model=4608, n_heads=32, n_kv_heads=16, head_dim=128,
        d_ff=36864, vocab=256000, block_pattern=("local", "attn"),
        window=4096, attn_softcap=50.0, final_softcap=30.0, mlp="geglu",
        post_norm=True, embed_scale=True,
        rope_theta=10000.0, tie_embeddings=True,
    )


def smoke_config():
    return full_config().replace(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=192, vocab=512, window=16, dtype="float32", scan_chunk=32,
    )
