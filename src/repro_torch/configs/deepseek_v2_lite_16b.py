"""DeepSeek-V2-Lite (16B total / 2.4B active) [arXiv:2405.04434; hf].

27L, d_model 2048, 16 heads MLA (kv_lora 512, rope_dim 64, nope 128,
v_head 128, no q compression), vocab 102400.  MoE: 64 routed experts
top-6 + 2 shared, expert d_ff 1408; first layer dense d_ff 10944.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=10944, vocab=102400,
    mla=True, kv_lora=512, q_lora=0, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    n_experts=64, n_shared_experts=2, top_k=6, d_ff_expert=1408,
    first_dense_layers=1, tie_embeddings=False,
)
