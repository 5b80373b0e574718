"""falcon-mamba-7b [ssm] — 64L d=4096 attn-free vocab=65024 ssm_state=16,
Mamba-1 arch (d_inner = 2·d, dt_rank = d/16, conv 4, RMS on B/C/dt).
[arXiv:2410.05355; unverified]"""
from .base import ModelConfig


def full_config():
    return ModelConfig(
        name="falcon-mamba-7b", family="ssm",
        n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0, head_dim=0,
        d_ff=0, vocab=65024, block_pattern=("mamba",),
        ssm_state=16, ssm_conv=4, ssm_expand=2, dt_rank=256,
        ssm_rms_bcdt=True, tie_embeddings=True, subquadratic=True,
    )


def smoke_config():
    return full_config().replace(
        n_layers=2, d_model=64, vocab=512, dt_rank=8, ssm_state=4,
        dtype="float32", scan_chunk=32,
    )
