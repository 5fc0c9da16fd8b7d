"""Carry rotation sequences and request streams across from the JAX
reference package.

:func:`sequence_from_reference` takes what the reference's
``RotationSequence.to_dict()`` returns (waves as nested lists), or the
same keys holding numpy arrays, and rebuilds the waves bit for bit as a
port :class:`~repro_torch.core.sequence.RotationSequence`.
:func:`requests_from_reference` does the same for a request stream of
``(sequence dict, numpy target)`` pairs.
:func:`lm_params_from_reference` loads the reference model's ``init``
tree (any family), as numpy arrays, into the port's LM, and
:func:`train_state_from_reference` carries a training state across (the
parameters and the optimizer state of ``AdamW``, its ``Quantized`` q8
states, or ``SoapGivens``).  All read plain data only and import nothing
of the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.sequence import RotationSequence, resolve_device

__all__ = ["sequence_from_reference", "requests_from_reference",
           "lm_params_from_reference", "train_state_from_reference"]


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


def _tensors(tree, device):
    """A reference tree of numpy (or tensor) leaves as the port's: tensors
    on ``device`` (copies, dtypes kept), lists for the groups' slot lists,
    and the port's ``Quantized`` for any named tuple with fields ``q`` and
    ``scale`` (the reference's)."""
    from repro_torch.optim.adamw import Quantized

    def one(x):
        if isinstance(x, tuple) and getattr(x, "_fields", None) == (
                "q", "scale"):
            return Quantized(one(x.q), one(x.scale))
        if isinstance(x, dict):
            return {k: one(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [one(v) for v in x]
        if isinstance(x, torch.Tensor):
            return x.detach().to(device, copy=True)
        return torch.from_numpy(np.array(x, copy=True)).to(device)

    return one(tree)


def lm_params_from_reference(params, cfg, *, device="cuda"):
    """The port's model of ``cfg`` (``models.build_model``) holding the
    reference's weights, bit for bit, on ``device``.

    ``params`` is the reference ``build_model(cfg).init(key)`` tree with
    numpy leaves, its layers stacked as the reference stacks them: the
    Transformer's ``group{gi}`` (a list over a group's slots, leaves
    ``(reps, ...)``), Mamba2's ``blocks``, the RG-LRU hybrid's ``group0``
    and ``tail{i}``, Whisper's ``enc`` and ``dec``; the zoo's
    :func:`~repro_torch.models.zoo.unstack_params` names each row by the
    port's parameter.  Dense weights keep their ``(d_in, d_out)`` layout:
    nothing is transposed.
    """
    from repro_torch.models.zoo import build_model, unstack_params

    state = unstack_params(cfg, _tensors(params, "cpu"))
    # a template on the meta device draws no weight; assign=True makes
    # the loaded tensors its parameters
    model = build_model(cfg, device="meta")
    model.load_state_dict(state, strict=True, assign=True)
    return model.to(resolve_device(device))


def train_state_from_reference(params, opt_state, cfg, *, device="cuda"):
    """``(model, params, opt_state)`` of the port from the reference's
    training state (numpy leaves, stacked groups; a checkpoint the port's
    ``CheckpointManager.restore`` read with no ``like``, or
    ``jax.tree.map(np.asarray, ...)`` of the live trees).

    The port trains in the reference's tree (the zoo's
    ``stack_params``), so
    ``params`` and ``opt_state`` keep their structure: ``step``, AdamW's
    ``m``/``v`` (float32 or ``Quantized``), SoapGivens' ``per`` leaves
    with ``L``/``R``/``QL``/``QR`` where the reference preconditions.
    ``model`` is the port's LM holding those weights, unstacked by
    :func:`lm_params_from_reference`, for the train step and for serving.
    """
    device = resolve_device(device)
    model = lm_params_from_reference(params, cfg, device=device)
    return (model, _tensors(params, device), _tensors(opt_state, device))
