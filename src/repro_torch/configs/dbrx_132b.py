"""dbrx-132b [moe] — 40L d=6144 48H (GQA kv=8) expert d_ff=10752
vocab=100352; 16 experts top-4, fine-grained.
[hf:databricks/dbrx-base; unverified]"""
from .base import ModelConfig


def full_config():
    return ModelConfig(
        name="dbrx-132b", family="moe",
        n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
        d_ff=10752, vocab=100352, rope_theta=500000.0,
        moe=True, n_experts=16, n_shared_experts=0, top_k=4, d_ff_expert=10752,
    )


def smoke_config():
    return full_config().replace(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
        d_ff=128, vocab=512, n_experts=4, top_k=2, d_ff_expert=48,
        dtype="float32", scan_chunk=32, moe_group_size=64,
    )
