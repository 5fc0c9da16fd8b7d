"""Chameleon-34B [arXiv:2405.09818] — early-fusion VLM.

48L, d_model 8192, 64 heads (GQA kv=8), d_ff 22016 (SwiGLU), vocab 65536
(text + VQ-VAE image tokens early-fused into one vocabulary — the image
"frontend" is the discrete VQ tokenizer, so model inputs are plain token
ids; see DESIGN.md).  qk-norm (chameleon's stabilization), untied. ~34B.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=22016, vocab=65536, qk_norm=True, tie_embeddings=False,
    dryrun_grad_accum=4,
)
