"""Carry rotation sequences across from the JAX reference package.

:func:`sequence_from_reference` takes what the reference's
``RotationSequence.to_dict()`` returns (waves as nested lists), or the
same keys holding numpy arrays, and rebuilds the waves bit for bit as a
port :class:`~repro_torch.core.sequence.RotationSequence`.  It reads
plain data only and imports nothing of the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sequence import RotationSequence, resolve_device

__all__ = ["sequence_from_reference"]

_DTYPES = {"float32": np.float32, "float64": np.float64}


def sequence_from_reference(d: dict, *, device="cuda") -> RotationSequence:
    """Rebuild a reference sequence from ``d`` on ``device``.

    ``d`` has ``cos``, ``sin`` and optionally ``sign``, ``reflect``,
    ``k_live`` and ``dtype`` (``"float32"`` or ``"float64"``; by default
    the dtype of ``cos`` when it is a numpy array, else float32).  The
    waves are stored untouched: no renormalization.
    """
    default = getattr(d["cos"], "dtype", np.dtype(np.float32))
    name = str(d.get("dtype") or default)
    if name not in _DTYPES:
        raise ValueError(f"unsupported wave dtype {name!r}; one of "
                         f"{sorted(_DTYPES)}")
    device = resolve_device(device)

    def conv(x):
        return torch.from_numpy(
            np.array(x, dtype=_DTYPES[name], copy=True)).to(device)

    sign = d.get("sign")
    k_live = d.get("k_live")
    return RotationSequence(
        conv(d["cos"]), conv(d["sin"]),
        None if sign is None else conv(sign),
        bool(d.get("reflect", False)),
        None if k_live is None else int(k_live))
