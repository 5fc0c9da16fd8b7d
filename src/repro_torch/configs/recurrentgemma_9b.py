"""RecurrentGemma-9B (Griffin) [arXiv:2402.19427].

38 residual blocks, d_model 4096, pattern (R, R, A): RG-LRU recurrent
blocks (lru_width 4096) with local MQA attention every third block
(16 heads, kv=1, head_dim 256, window 2048), d_ff 12288 (GeGLU, gated),
vocab 256000.  ~9B params.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, head_dim=256,
    d_ff=12288, vocab=256000,
    window=2048, lru_width=4096, emb_scale=True, tie_embeddings=True,
)
