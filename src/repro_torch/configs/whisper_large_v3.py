"""Whisper-large-v3 [arXiv:2212.04356] — encoder-decoder, audio.

32 encoder + 32 decoder layers, d_model 1280, 20 heads, d_ff 5120
(plain GELU), vocab 51866.  Conv/mel frontend is a STUB per the
assignment: inputs are precomputed frame embeddings.  ~1.5B params.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab=51866, pos_type="none", mlp_gated=False,
    enc_layers=32, dec_layers=32, dec_len=448, tie_embeddings=True,
)
