"""Llama-3.1-405B [arXiv:2407.21783].

126L, d_model 16384, 128 heads (GQA kv=8, head_dim 128), d_ff 53248
(SwiGLU), vocab 128256, RoPE base 500k, untied embeddings. ~405B params.

Memory policy: at the 256-chip single pod, fp32 Adam is physically
impossible (405B x 12 B/param = 4.9 TB > 256 x 16 GiB), so the dry-run
trains with bf16 params + 8-bit Adam states (+ grad accumulation and
sequence parallelism) — same policy as kimi-k2.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b", family="dense",
    n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8, head_dim=128,
    d_ff=53248, vocab=128256, rope_base=500000.0, tie_embeddings=False,
    param_dtype="bfloat16", dryrun_grad_accum=8, dryrun_seq_parallel=True,
    dryrun_q8=True,
)
