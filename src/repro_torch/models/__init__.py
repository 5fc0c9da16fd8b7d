"""LM substrates of the port: mirror of :mod:`repro.models` (the dense
decoder-only transformer and its GQA attention)."""
from .zoo import build_model

__all__ = ["build_model"]
