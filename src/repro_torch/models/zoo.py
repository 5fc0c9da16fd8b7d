"""Model zoo: build a ported architecture from its config.

Mirror of :mod:`repro.models.zoo`.  The decoder-only families (dense,
moe, vlm) go to :class:`~repro_torch.models.transformer.Transformer`;
the SSM, hybrid and audio families are not ported yet.
"""
from __future__ import annotations

from .transformer import Transformer

__all__ = ["build_model"]

_WAITING = {"ssm": "Mamba2", "hybrid": "RG-LRU (RecurrentGemma)",
            "audio": "Whisper"}


def build_model(cfg, **kwargs):
    """``Transformer(cfg, **kwargs)`` for the families the port has."""
    if cfg.family in _WAITING:
        raise NotImplementedError(
            f"{cfg.name}: the {_WAITING[cfg.family]} family is not ported "
            f"yet (ROADMAP Queue 1 item 12)")
    # dense / moe / vlm share the decoder-only transformer
    return Transformer(cfg, **kwargs)
