"""LM substrates of the port: mirror of :mod:`repro.models` (the
decoder-only transformer with GQA/MLA attention and MoE, Mamba-2, the
RG-LRU hybrid and the Whisper encoder-decoder)."""
from .zoo import build_model

__all__ = ["build_model"]
