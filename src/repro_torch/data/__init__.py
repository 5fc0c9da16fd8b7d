"""Synthetic data pipeline of the port: mirror of :mod:`repro.data`."""
from .pipeline import DataConfig, SyntheticLM, make_batch, model_batch

__all__ = ["DataConfig", "SyntheticLM", "make_batch", "model_batch"]
