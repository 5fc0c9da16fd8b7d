"""Rotation-sequence application: the port's core.

Mirror of :mod:`repro.core`: ``sequence`` (the plan-once / apply-many
type), ``registry`` (capabilities, SS6 cost model, plan cache), ``ref``
(Alg 1.2/1.3 and the numpy oracle), ``blocked`` (SS2/SS5 blocking),
``accumulate`` (rs_gemm), ``api`` (backend registration), ``jacobi``
(the round-robin Jacobi eigensolver that records reflector sequences).
"""
from .api import METHODS, apply_rotation_sequence
from .jacobi import JacobiResult, jacobi_apply_basis, jacobi_eigh
from .rotations import (RotationSequence, givens, identity_sequence,
                        random_sequence, sequence_to_dense)
from .sequence import SequencePlan

__all__ = [
    "METHODS", "apply_rotation_sequence",
    "RotationSequence", "SequencePlan", "givens", "identity_sequence",
    "random_sequence", "sequence_to_dense",
    "JacobiResult", "jacobi_eigh", "jacobi_apply_basis",
]
