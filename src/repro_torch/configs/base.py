"""Config system: architecture + shape + run configuration.

Every assigned architecture is a ``ModelConfig`` instance in its own
module (``repro_torch/configs/<arch>.py``, copied from ``repro.configs``)
with the exact published numbers.  ``ModelConfig.reduced()`` returns a
family-preserving scaled-down config for CPU tests.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

__all__ = ["ModelConfig", "ShapeConfig", "SHAPES", "shape_skips"]


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None    # default: d_model // n_heads

    # positions / attention
    pos_type: str = "rope"            # rope | sinusoidal | none
    rope_base: float = 10000.0
    rope_base_global: Optional[float] = None  # gemma3 global layers
    qk_norm: bool = False
    window: Optional[int] = None      # sliding-window size for local layers
    # layer pattern: (period, global/attn positions within the period)
    # dense default: every layer is the same block.
    pattern_period: int = 1
    pattern_global: Tuple[int, ...] = (0,)  # which slots use global attn
    # hybrid (recurrentgemma): slots NOT in pattern_global are RG-LRU /
    # local-attention per family.

    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25

    # MLA (deepseek-style latent attention)
    mla: bool = False
    kv_lora: int = 0
    q_lora: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # SSM (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_groups: int = 1
    ssm_chunk: int = 256
    conv_width: int = 4
    ssm_expand: int = 2

    # RG-LRU (recurrentgemma)
    lru_width: Optional[int] = None

    # encoder-decoder (whisper)
    enc_layers: int = 0
    dec_layers: int = 0
    dec_len: int = 448

    # MLP
    mlp_gated: bool = True            # SwiGLU (llama) vs plain GELU

    # embeddings
    tie_embeddings: bool = True
    emb_scale: bool = False           # gemma-style sqrt(d) embed scaling

    # numerics
    dtype: str = "bfloat16"           # activation/compute dtype
    param_dtype: str = "float32"
    logit_softcap: float = 0.0

    # dry-run / production policy (memory-fit levers per arch)
    dryrun_grad_accum: int = 1
    dryrun_seq_parallel: bool = False
    dryrun_q8: bool = False           # 8-bit Adam states

    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))

    @property
    def is_encdec(self) -> bool:
        return self.enc_layers > 0

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def reduced(self) -> "ModelConfig":
        """Family-preserving tiny config for CPU smoke tests."""
        def shrink(v, lo, hi):
            return max(lo, min(v, hi))

        kw = dict(
            n_layers=shrink(self.n_layers, 2, 4),
            d_model=64,
            n_heads=4,
            n_kv_heads=shrink(self.n_kv_heads, 1, 2),
            head_dim=16,
            d_ff=128,
            vocab=512,
            window=min(self.window, 16) if self.window else None,
        )
        if self.n_experts:
            kw.update(n_experts=4, n_shared_experts=min(self.n_shared_experts, 1),
                      top_k=2, d_ff_expert=32,
                      first_dense_layers=min(self.first_dense_layers, 1))
        if self.mla:
            kw.update(kv_lora=16, q_lora=0, qk_nope_dim=16, qk_rope_dim=8,
                      v_head_dim=16)
        if self.ssm_state:
            kw.update(ssm_state=16, ssm_head_dim=8, ssm_chunk=8)
        if self.is_encdec:
            kw.update(enc_layers=2, dec_layers=2, dec_len=16)
            kw["n_layers"] = 2
        if self.lru_width is not None:
            kw.update(lru_width=64)
        if self.family == "hybrid":
            kw["n_layers"] = 3 * max(1, self.n_layers // (3 * 13))  # keep R,R,A
        if self.pattern_period > 1:
            kw["n_layers"] = max(self.pattern_period,
                                 kw["n_layers"] - kw["n_layers"] % self.pattern_period)
        kw["dtype"] = "float32"
        kw["param_dtype"] = "float32"
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}

# archs with pure full attention skip long_500k (O(seq) KV decode is fine
# but the assignment restricts the 500k cell to sub-quadratic families)
_FULL_ATTN = {
    "starcoder2-3b", "smollm-135m", "llama3-405b", "chameleon-34b",
    "deepseek-v2-lite-16b", "kimi-k2-1t-a32b", "whisper-large-v3",
}


def shape_skips(cfg: ModelConfig, shape: ShapeConfig) -> Optional[str]:
    """Return a skip reason or None if the (arch, shape) cell runs."""
    if shape.name == "long_500k" and cfg.name in _FULL_ATTN:
        return "pure full-attention arch: long_500k skipped per assignment"
    return None
