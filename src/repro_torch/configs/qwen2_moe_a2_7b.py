"""qwen2-moe-a2.7b [moe] — 24L d=2048 16H (GQA kv=16) expert d_ff=1408
vocab=151936; 4 shared + 60 routed experts, top-4.
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]"""
from .base import ModelConfig


def full_config():
    return ModelConfig(
        name="qwen2-moe-a2.7b", family="moe",
        n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
        d_ff=5632, vocab=151936, qkv_bias=True, rope_theta=1000000.0,
        moe=True, n_experts=60, n_shared_experts=4, top_k=4, d_ff_expert=1408,
    )


def smoke_config():
    return full_config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
        d_ff=128, vocab=512, n_experts=8, n_shared_experts=1, top_k=2,
        d_ff_expert=32, dtype="float32", scan_chunk=32, moe_group_size=64,
    )
