"""PyTorch/CUDA port of the rotation-sequence library ``repro``.

Applies a recorded sequence of planar rotations to a matrix,
``A <- A @ Q``, through ``seq.plan(like=A).apply(A)``, and serves many
such requests batched by shape (``repro_torch.serve``, through
``plan.apply_batched``), records such sequences in eigensolvers
and an SVD whose vectors accumulate through the same plans
(``repro_torch.eig``), and shards the rows of a target over a
``torch.distributed`` device mesh (``repro_torch.dist``): on an NVIDIA
H100 by hand-written CUDA kernels (``kernels/``), on the CPU by their
plain PyTorch versions.  The training slice trains the LM substrates
(``repro_torch.train``: ``make_train_step``, ``TrainLoop``) with
``repro_torch.optim`` (``AdamW``, and ``SoapGivens``, whose eigenbasis
refreshes record rotations and apply them through the same plans), the
synthetic pipeline ``repro_torch.data``, checkpoints in the reference's
layout (``repro_torch.ckpt``) and gradient compression
(``repro_torch.parallel``).  Imports ``torch`` and ``numpy`` only.
"""
from . import ckpt, data, optim, parallel, train
from .core import (METHODS, RotationSequence, SequencePlan,
                   apply_rotation_sequence, identity_sequence,
                   random_sequence, sequence_to_dense)

__all__ = [
    "METHODS", "RotationSequence", "SequencePlan",
    "apply_rotation_sequence", "identity_sequence", "random_sequence",
    "sequence_to_dense", "ckpt", "data", "optim", "parallel", "train",
]
