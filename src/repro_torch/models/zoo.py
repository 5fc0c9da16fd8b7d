"""Model zoo: build a ported architecture from its config.

Mirror of :mod:`repro.models.zoo`.  The decoder-only families (dense,
moe, vlm) go to :class:`~repro_torch.models.transformer.Transformer`,
``ssm`` to :class:`~repro_torch.models.mamba2.Mamba2`, ``hybrid`` to
:class:`~repro_torch.models.rglru.RecurrentHybrid` and ``audio`` to
:class:`~repro_torch.models.whisper.WhisperBackbone`.

Each family's module also carries its parameter tree to and from the
reference's: :func:`stack_params` makes the reference's tree (the one
the train step trains and a checkpoint holds) from a model's
``params()``, :func:`unstack_params` names its rows by the model's
parameters, and :func:`reference_shapes` gives its shapes on the meta
device.
"""
from __future__ import annotations

import torch

from . import mamba2, rglru, transformer, whisper

__all__ = ["build_model", "stack_params", "unstack_params",
           "reference_shapes"]

_FAMILY = {"ssm": (mamba2, mamba2.Mamba2),
           "hybrid": (rglru, rglru.RecurrentHybrid),
           "audio": (whisper, whisper.WhisperBackbone)}


def _family(cfg):
    # dense / moe / vlm share the decoder-only transformer
    return _FAMILY.get(cfg.family, (transformer, transformer.Transformer))


def build_model(cfg, **kwargs):
    """The port's model of ``cfg``'s family (``generator=``, ``device=``
    as :class:`~repro_torch.models.layers.TreeModel` takes them)."""
    return _family(cfg)[1](cfg, **kwargs)


def stack_params(cfg, tree):
    """The reference's parameter tree from a model's ``params()``."""
    return _family(cfg)[0].stack_params(cfg, tree)


def unstack_params(cfg, tree) -> dict:
    """``{parameter name: tensor}`` of the model from the reference's
    tree, for ``load_state_dict`` and ``torch.func.functional_call``."""
    return _family(cfg)[0].unstack_params(cfg, tree)


def reference_shapes(cfg):
    """The reference's parameter tree as meta tensors: its shapes, with
    no weights built."""
    with torch.device("meta"):
        return stack_params(cfg, _family(cfg)[0].init_params(cfg, None))
