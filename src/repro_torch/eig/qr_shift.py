"""Implicit Wilkinson-shift QR on a symmetric tridiagonal matrix, each
bulge-chasing sweep recorded as one wave of the paper's ``(n-1, K)``
rotation layout instead of applied.

Mirror of :mod:`repro.eig.qr_shift`, pure float64 numpy, the same
operations in the same order, so values and waves equal the
reference's bit for bit.  A sweep on the active block ``[lo, hi]``
generates rotations in planes ``lo, ..., hi-1`` in ascending order: one
wave, identity outside the block.  Per rotation ``(c, s)`` at plane
``(j, j+1)`` (``T' = G^T T G``, ``G = [[c, -s], [s, c]]``)::

    d[j]'   =  c^2 d[j] + 2 c s e[j] + s^2 d[j+1]
    d[j+1]' =  s^2 d[j] - 2 c s e[j] + c^2 d[j+1]
    e[j]'   =  c s (d[j+1] - d[j]) + (c^2 - s^2) e[j]

with the bulge ``s * e[j+1]`` entering at ``(j+2, j)``.  Deflated
off-diagonals are set to exactly zero, so blocks are independent.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from .tridiag import host_givens

__all__ = ["TridiagQRResult", "tridiag_qr", "wilkinson_shift"]

_EPS = float(np.finfo(np.float64).eps)


class TridiagQRResult(NamedTuple):
    eigenvalues: np.ndarray  # (n,) float64, unsorted (deflation order)
    cos: np.ndarray          # (n-1, sweeps) one recorded wave per sweep
    sin: np.ndarray          # (n-1, sweeps)
    sweeps: int              # waves recorded
    converged: bool          # all off-diagonals deflated within budget


def wilkinson_shift(a: float, b: float, c: float) -> float:
    """Eigenvalue of ``[[a, b], [b, c]]`` closest to ``c`` (stable form)."""
    if b == 0.0:
        return c
    delta = (a - c) / 2.0
    sgn = 1.0 if delta >= 0.0 else -1.0
    return c - b * b / (delta + sgn * float(np.hypot(delta, b)))


def tridiag_qr(d, e, *, tol: Optional[float] = None,
               max_sweeps: Optional[int] = None) -> TridiagQRResult:
    """Diagonalize ``tridiag(d, e)``; record every sweep as a wave.

    Args:
      d: ``(n,)`` diagonal.  e: ``(n-1,)`` off-diagonal.
      tol: relative deflation threshold (default machine eps).
      max_sweeps: sweep budget (default ``40 n``).  A truncated run
        still returns a valid sequence, with ``converged=False``.

    Applying the recorded waves to ``M`` computes ``M @ U`` where
    ``U^T T U = diag(eigenvalues)``.
    """
    d = np.array(d, dtype=np.float64)
    e = np.array(e, dtype=np.float64)
    n = d.shape[0]
    if e.shape[0] != max(0, n - 1):
        raise ValueError(f"off-diagonal shape {e.shape} does not match "
                         f"n={n}")
    tol = _EPS if tol is None else float(tol)
    if max_sweeps is None:
        max_sweeps = 40 * max(1, n)
    waves_c: list = []
    waves_s: list = []
    if n <= 1:
        return TridiagQRResult(d, np.ones((max(0, n - 1), 0)),
                               np.zeros((max(0, n - 1), 0)), 0, True)

    def negligible(i: int) -> bool:
        return abs(e[i]) <= tol * (abs(d[i]) + abs(d[i + 1]))

    def pack(converged: bool) -> TridiagQRResult:
        C = np.stack(waves_c, 1) if waves_c else np.ones((n - 1, 0))
        S = np.stack(waves_s, 1) if waves_s else np.zeros((n - 1, 0))
        return TridiagQRResult(d, C, S, len(waves_c), converged)

    hi = n - 1
    while hi > 0:
        while hi > 0 and negligible(hi - 1):
            e[hi - 1] = 0.0
            hi -= 1
        if hi == 0:
            break
        if len(waves_c) >= max_sweeps:
            return pack(False)
        lo = hi - 1
        while lo > 0 and not negligible(lo - 1):
            lo -= 1
        if lo > 0:
            e[lo - 1] = 0.0  # deflate exactly: blocks become independent

        cvec = np.ones(n - 1, np.float64)
        svec = np.zeros(n - 1, np.float64)
        mu = wilkinson_shift(d[hi - 1], e[hi - 1], d[hi])
        x = d[lo] - mu
        z = e[lo]
        for j in range(lo, hi):
            c, s = host_givens(x, z)
            cvec[j] = c
            svec[j] = s
            if j > lo:
                e[j - 1] = c * e[j - 1] + s * z  # z is the bulge here
            dj, dj1, ej = d[j], d[j + 1], e[j]
            d[j] = c * c * dj + 2.0 * c * s * ej + s * s * dj1
            d[j + 1] = s * s * dj - 2.0 * c * s * ej + c * c * dj1
            e[j] = c * s * (dj1 - dj) + (c * c - s * s) * ej
            if j < hi - 1:
                bulge = s * e[j + 1]
                e[j + 1] = c * e[j + 1]
                x = e[j]
                z = bulge
        waves_c.append(cvec)
        waves_s.append(svec)

    return pack(True)
