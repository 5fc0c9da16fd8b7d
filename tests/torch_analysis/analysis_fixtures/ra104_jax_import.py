# repro-torch-lint: fixture-as=src/repro_torch/models/bad_jax.py
"""RA104 fixture: the port importing JAX or the reference package.

The reference's JAX-free modules count too, and so do dynamic imports
with a literal name.
"""
import importlib

import jax  # expect: RA104
import jax.numpy as jnp  # expect: RA104
from repro.core import RotationSequence  # expect: RA104
from repro.analysis import engine as _engine  # expect: RA104


def bad_dynamic():
    return importlib.import_module("jax.numpy")  # expect: RA104


def bad_dunder():
    return __import__("repro.hw")  # expect: RA104


def fine_port():
    return importlib.import_module("repro_torch.hw"), jax, jnp, RotationSequence, _engine
