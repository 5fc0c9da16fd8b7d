"""Mamba2-370M [arXiv:2405.21060] — SSD state-space model.

48L, d_model 1024 (d_inner 2048, 32 heads of dim 64), ssm_state 128,
1 group, chunk 256, vocab 50280.  Attention-free. ~370M params.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, head_dim=1,
    d_ff=0, vocab=50280, pos_type="none",
    ssm_state=128, ssm_head_dim=64, ssm_groups=1, ssm_chunk=256,
    ssm_expand=2, conv_width=4, tie_embeddings=True,
)
