"""Rotation-sequence application: the port's core.

Mirror of :mod:`repro.core`: ``sequence`` (the plan-once / apply-many
type), ``registry`` (capabilities, SS6 cost model, plan cache), ``ref``
(Alg 1.2/1.3 and the numpy oracle), ``blocked`` (SS2/SS5 blocking),
``accumulate`` (rs_gemm), ``api`` (backend registration).
"""
from .api import METHODS, apply_rotation_sequence
from .rotations import (RotationSequence, givens, identity_sequence,
                        random_sequence, sequence_to_dense)
from .sequence import SequencePlan

__all__ = [
    "METHODS", "apply_rotation_sequence",
    "RotationSequence", "SequencePlan", "givens", "identity_sequence",
    "random_sequence", "sequence_to_dense",
]
