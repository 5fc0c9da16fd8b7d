"""Eigensolvers and SVD built on recorded rotation sequences.

Mirror of :mod:`repro.eig` (paper SS5.1): the solvers record every
rotation on the host into the paper's ``(n-1, K)`` wave layout and flush
them in delayed batches through the planned appliers, on the card
through the hand-written kernels.

Public API: :func:`eigh_givens`, :func:`svd_givens`; building blocks:
:func:`tridiagonalize`, :func:`bidiagonalize`,
:class:`DelayedRotationBuffer`.
"""
from .api import EighResult, SvdResult, eigh_givens, svd_givens
from .delayed import DelayedRotationBuffer
from .qr_shift import TridiagQRResult, tridiag_qr
from .svd import BidiagQRResult, BidiagResult, bidiag_qr, bidiagonalize
from .tridiag import TridiagResult, tridiag_wave_count, tridiagonalize

__all__ = [
    "EighResult", "SvdResult", "eigh_givens", "svd_givens",
    "DelayedRotationBuffer",
    "TridiagResult", "tridiagonalize", "tridiag_wave_count",
    "TridiagQRResult", "tridiag_qr",
    "BidiagResult", "BidiagQRResult", "bidiagonalize", "bidiag_qr",
]
