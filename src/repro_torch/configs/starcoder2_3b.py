"""StarCoder2-3B [arXiv:2402.19173; hf:bigcode/starcoder2-3b].

30L, d_model 3072, 24 heads (GQA kv=2), d_ff 12288 (plain GELU MLP),
vocab 49152, RoPE.  ~3.0B params.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2, head_dim=128,
    d_ff=12288, vocab=49152,
    mlp_gated=False, rope_base=999999.0, tie_embeddings=True,
)
