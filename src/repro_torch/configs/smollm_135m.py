"""SmolLM-135M [hf:HuggingFaceTB/SmolLM-135M] — llama-arch small.

30L, d_model 576, 9 heads (GQA kv=3), d_ff 1536 (SwiGLU), vocab 49152.
~135M params, tied embeddings.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m", family="dense",
    n_layers=30, d_model=576, n_heads=9, n_kv_heads=3, head_dim=64,
    d_ff=1536, vocab=49152, rope_base=10000.0, tie_embeddings=True,
)
