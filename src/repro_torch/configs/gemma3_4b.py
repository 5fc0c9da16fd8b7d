"""Gemma-3-4B [hf:google/gemma-3-4b-pt].

34L, d_model 2560, 8 heads (GQA kv=4, head_dim 256), d_ff 10240 (GeGLU),
vocab 262144.  5:1 local:global pattern, sliding window 1024, RoPE base
10k local / 1M global, qk-norm, sqrt(d) embedding scaling, tied. ~4B.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=10240, vocab=262144,
    window=1024, pattern_period=6, pattern_global=(5,),
    rope_base=10000.0, rope_base_global=1000000.0,
    qk_norm=True, emb_scale=True, tie_embeddings=True,
    dryrun_grad_accum=4,
)
