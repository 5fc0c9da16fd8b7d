"""Optimizers of the port: mirror of :mod:`repro.optim`."""
from .adamw import AdamW, Quantized, dequantize_q8, quantize_q8
from .schedule import constant, warmup_cosine
from .soap_givens import SoapGivens

__all__ = ["AdamW", "Quantized", "dequantize_q8", "quantize_q8",
           "constant", "warmup_cosine", "SoapGivens"]
