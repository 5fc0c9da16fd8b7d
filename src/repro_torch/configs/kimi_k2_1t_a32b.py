"""Kimi-K2 (1T total / 32B active) [arXiv:2501.kimi2; paper-table].

61L, d_model 7168, 64 heads (GQA kv=8 per the assignment table; the
released K2 uses MLA — we follow the assignment), vocab 163840.
MoE: 384 routed experts top-8 + 1 shared, expert d_ff 2048; first layer
dense d_ff 18432.  ~1.03T params.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=18432, vocab=163840,
    n_experts=384, n_shared_experts=1, top_k=8, d_ff_expert=2048,
    first_dense_layers=1, tie_embeddings=False, rope_base=50000.0,
    param_dtype="bfloat16", dryrun_grad_accum=8, dryrun_seq_parallel=True,
    dryrun_q8=True,
)
