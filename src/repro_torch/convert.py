"""Carry rotation sequences and request streams across from the JAX
reference package.

:func:`sequence_from_reference` takes what the reference's
``RotationSequence.to_dict()`` returns (waves as nested lists), or the
same keys holding numpy arrays, and rebuilds the waves bit for bit as a
port :class:`~repro_torch.core.sequence.RotationSequence`.
:func:`requests_from_reference` does the same for a request stream of
``(sequence dict, numpy target)`` pairs.
:func:`lm_params_from_reference` loads the reference ``Transformer.init``
tree, as numpy arrays, into the port's LM.  All read plain data only and
import nothing of the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sequence import RotationSequence, resolve_device

__all__ = ["sequence_from_reference", "requests_from_reference",
           "lm_params_from_reference"]


def sequence_from_reference(d: dict, *, device="cuda") -> RotationSequence:
    """Rebuild a reference sequence from ``d`` on ``device``.

    ``d`` has ``cos``, ``sin`` and optionally ``sign``, ``reflect``,
    ``k_live`` and ``dtype`` (``"float32"`` or ``"float64"``; by default
    the dtype of ``cos`` when it is a numpy array, else float32).  The
    waves are stored untouched: no renormalization.
    """
    return RotationSequence.from_dict(d, device=device)


def requests_from_reference(pairs, *, device="cuda"):
    """``[(sequence dict, target array)]`` -> ``[(RotationSequence,
    tensor)]`` on ``device``, bit for bit (targets keep their dtype)."""
    device = resolve_device(device)
    return [(sequence_from_reference(d, device=device),
             torch.from_numpy(np.array(A, copy=True)).to(device))
            for d, A in pairs]


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flatten(v, f"{prefix}{k}.", out)
    else:
        out[prefix[:-1]] = tree
    return out


def lm_params_from_reference(params, cfg, *, device="cuda"):
    """A port :class:`~repro_torch.models.transformer.Transformer` holding
    the reference's weights, bit for bit, on ``device``.

    ``params`` is the reference ``Transformer(cfg).init(key)`` tree with
    numpy leaves: ``embed``, ``ln_f``, ``lm_head`` (untied configs) and
    ``group{gi}``, a list over the group's slots whose leaves are stacked
    ``(reps, ...)``.  Global layer ``start + r * len(slots) + s`` takes
    repetition ``r`` of slot ``s``.  Dense weights keep their
    ``(d_in, d_out)`` layout: nothing is transposed.
    """
    from repro_torch.models.transformer import Transformer, _groups

    state = {}
    for key in ("embed", "ln_f", "lm_head"):
        if key in params:
            _flatten(params[key], f"{key}.", state)
    for gi, (start, count, slot_kinds) in enumerate(_groups(cfg)):
        P = len(slot_kinds)
        for s, slot in enumerate(params[f"group{gi}"]):
            for name, leaf in _flatten(slot, "", {}).items():
                for r in range(count // P):
                    state[f"layers.{start + r * P + s}.{name}"] = leaf[r]
    model = Transformer(cfg, device="cpu")
    model.load_state_dict({k: torch.from_numpy(np.array(v, copy=True))
                           for k, v in state.items()}, strict=True)
    return model.to(resolve_device(device))
