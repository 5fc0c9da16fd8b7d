"""Config registry: one module per assigned architecture.

Mirror of :mod:`repro.configs`; the modules are data only and copied
unchanged, so a port config equals its reference field for field.
"""
from importlib import import_module

from .base import SHAPES, ModelConfig, ShapeConfig, shape_skips

ARCHS = (
    "starcoder2-3b", "smollm-135m", "llama3-405b", "gemma3-4b",
    "recurrentgemma-9b", "chameleon-34b", "deepseek-v2-lite-16b",
    "kimi-k2-1t-a32b", "mamba2-370m", "whisper-large-v3",
)


def get_config(name: str) -> ModelConfig:
    mod = import_module(f"repro_torch.configs.{name.replace('-', '_')}")
    return mod.CONFIG


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "get_config",
           "shape_skips"]
