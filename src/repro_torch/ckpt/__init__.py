"""Checkpointing of the port: mirror of :mod:`repro.ckpt`."""
from .manager import CheckpointManager

__all__ = ["CheckpointManager"]
