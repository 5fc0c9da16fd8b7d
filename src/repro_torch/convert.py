"""Carry rotation sequences and request streams across from the JAX
reference package.

:func:`sequence_from_reference` takes what the reference's
``RotationSequence.to_dict()`` returns (waves as nested lists), or the
same keys holding numpy arrays, and rebuilds the waves bit for bit as a
port :class:`~repro_torch.core.sequence.RotationSequence`.
:func:`requests_from_reference` does the same for a request stream of
``(sequence dict, numpy target)`` pairs.  Both read plain data only and
import nothing of the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sequence import RotationSequence, resolve_device

__all__ = ["sequence_from_reference", "requests_from_reference"]


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
