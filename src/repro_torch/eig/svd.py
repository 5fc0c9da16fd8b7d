"""Golub-Kahan SVD machinery recorded as adjacent-plane rotation sequences.

Mirror of :mod:`repro.eig.svd`, pure float64 numpy, the same operations
in the same order, so every recording equals the reference's bit for
bit.

* :func:`bidiagonalize` reduces ``A`` (``m >= n``) to upper bidiagonal
  ``B = U^T A V`` with adjacent-plane Givens only: sweep ``t`` zeroes
  column ``t`` below the diagonal bottom-up with row rotations (an
  ``(m-1, K_L)`` left sequence), then row ``t`` right of the
  superdiagonal with column rotations (an ``(n-1, K_R)`` right
  sequence), both in the staircase packing of :mod:`.tridiag`.
* :func:`bidiag_qr` runs implicit-shift QR on the band (shift from the
  trailing 2x2 of ``B^T B``, a zero shift near a tiny diagonal); each
  sweep records one right and one left wave.

Applying the left sequence to ``M`` computes ``M @ U``, the right one
``M @ V``, with ``A = U B V^T``.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np

from repro_torch.core.rotations import plane_update

from .qr_shift import wilkinson_shift
from .tridiag import _host64, host_givens

__all__ = ["BidiagResult", "BidiagQRResult", "bidiagonalize", "bidiag_qr"]

_EPS = float(np.finfo(np.float64).eps)


class BidiagResult(NamedTuple):
    """``B = U^T A V`` (upper bidiagonal), factors as recorded sequences."""

    diag: np.ndarray       # (n,)   float64 main diagonal of B
    superdiag: np.ndarray  # (n-1,) float64 superdiagonal of B
    cos_left: np.ndarray   # (m-1, K_L) row-space rotations (U factor)
    sin_left: np.ndarray
    cos_right: np.ndarray  # (n-1, K_R) column-space rotations (V factor)
    sin_right: np.ndarray


def bidiagonalize(A) -> BidiagResult:
    """Adjacent-plane Givens bidiagonalization of ``A`` with ``m >= n``."""
    A = _host64(A)
    m, n = A.shape
    if m < n:
        raise ValueError(f"bidiagonalize expects m >= n, got {A.shape}; "
                         f"transpose first (svd_givens does)")
    # wave counts of the staircase packing (max index + 1, see tridiag)
    KL = max(0, (m - 2) + (n - 1) + 1) if m >= 2 else 0
    KR = max(0, 2 * n - 5)
    CL = np.ones((max(m - 1, 0), KL), np.float64)
    SL = np.zeros((max(m - 1, 0), KL), np.float64)
    CR = np.ones((max(n - 1, 0), KR), np.float64)
    SR = np.zeros((max(n - 1, 0), KR), np.float64)
    for t in range(n):
        # rows: zero A[t+1:, t] bottom-up, planes (i, i+1), i = m-2 .. t
        for i in range(m - 2, t - 1, -1):
            c, s = host_givens(A[i, t], A[i + 1, t])
            if s != 0.0:
                A[i, t:], A[i + 1, t:] = plane_update(
                    A[i, t:], A[i + 1, t:], c, s, -1.0)
            CL[i, (m - 2 - i) + 2 * t] = c
            SL[i, (m - 2 - i) + 2 * t] = s
        # columns: zero A[t, t+2:] right to left, planes (j, j+1),
        # j = n-2 .. t+1
        for j in range(n - 2, t, -1):
            c, s = host_givens(A[t, j], A[t, j + 1])
            if s != 0.0:
                A[t:, j], A[t:, j + 1] = plane_update(
                    A[t:, j], A[t:, j + 1], c, s, -1.0)
            CR[j, (n - 2 - j) + 2 * t] = c
            SR[j, (n - 2 - j) + 2 * t] = s
    d = np.diagonal(A).copy()
    f = np.diagonal(A, offset=1).copy() if n > 1 else np.zeros(0)
    return BidiagResult(d, f, CL, SL, CR, SR)


class BidiagQRResult(NamedTuple):
    values: np.ndarray     # (n,) float64 diagonal after QR (signed)
    cos_left: np.ndarray   # (n-1, sweeps) one wave per sweep (U side)
    sin_left: np.ndarray
    cos_right: np.ndarray  # (n-1, sweeps) one wave per sweep (V side)
    sin_right: np.ndarray
    sweeps: int
    converged: bool


def bidiag_qr(d, f, *, tol: Optional[float] = None,
              max_sweeps: Optional[int] = None) -> BidiagQRResult:
    """Implicit-shift QR on upper-bidiagonal ``(d, f)``; waves recorded.

    Returns the (possibly signed) diagonal and per-sweep left/right
    rotation waves: ``diag(values) = L^T B R``.  Sign fixing and sorting
    are the caller's job (column flips and permutations, not rotations).
    """
    d = np.array(d, dtype=np.float64)
    f = np.array(f, dtype=np.float64)
    n = d.shape[0]
    if f.shape[0] != max(0, n - 1):
        raise ValueError(f"superdiagonal shape {f.shape} vs n={n}")
    tol = _EPS if tol is None else float(tol)
    if max_sweeps is None:
        max_sweeps = 40 * max(1, n)
    J = max(0, n - 1)
    wcl: list = []
    wsl: list = []
    wcr: list = []
    wsr: list = []

    def pack(converged: bool) -> BidiagQRResult:
        CL = np.stack(wcl, 1) if wcl else np.ones((J, 0))
        SL = np.stack(wsl, 1) if wsl else np.zeros((J, 0))
        CR = np.stack(wcr, 1) if wcr else np.ones((J, 0))
        SR = np.stack(wsr, 1) if wsr else np.zeros((J, 0))
        return BidiagQRResult(d, CL, SL, CR, SR, len(wcl), converged)

    if n <= 1:
        return pack(True)

    def negligible(i: int) -> bool:
        return abs(f[i]) <= tol * (abs(d[i]) + abs(d[i + 1]))

    scale = float(np.max(np.abs(d)) + np.max(np.abs(f)))
    hi = n - 1
    while hi > 0:
        while hi > 0 and negligible(hi - 1):
            f[hi - 1] = 0.0
            hi -= 1
        if hi == 0:
            break
        if len(wcl) >= max_sweeps:
            return pack(False)
        lo = hi - 1
        while lo > 0 and not negligible(lo - 1):
            lo -= 1
        if lo > 0:
            f[lo - 1] = 0.0

        cl = np.ones(J, np.float64)
        sl = np.zeros(J, np.float64)
        cr = np.ones(J, np.float64)
        sr = np.zeros(J, np.float64)
        # an exactly zero leading diagonal stalls the implicit sweep (every
        # rotation would be the identity); the classical fix needs
        # non-adjacent planes, so nudge d[lo] by one deflation-tolerance
        # unit, the order of the deflation error itself
        if d[lo] == 0.0:
            blockscale = max(float(np.max(np.abs(d[lo:hi + 1]))),
                             float(np.max(np.abs(f[lo:hi]))))
            d[lo] = tol * max(blockscale, np.finfo(np.float64).tiny)
        # shift from the trailing 2x2 of B^T B; zero shift near a tiny
        # diagonal (keeps sweeps adjacent-plane)
        dm, dh, fm = d[hi - 1], d[hi], f[hi - 1]
        fm2 = f[hi - 2] if hi - 2 >= lo else 0.0
        if min(abs(dm), abs(dh)) <= tol * scale:
            mu = 0.0
        else:
            mu = wilkinson_shift(dm * dm + fm2 * fm2, dm * fm,
                                 dh * dh + fm * fm)
        y = d[lo] * d[lo] - mu
        z = d[lo] * f[lo]
        for j in range(lo, hi):
            # right rotation: columns (j, j+1)
            c, s = host_givens(y, z)
            cr[j] = c
            sr[j] = s
            if j > lo:
                f[j - 1] = c * f[j - 1] + s * z  # z = right bulge
            d[j], f[j] = plane_update(d[j], f[j], c, s, -1.0)
            bulge = s * d[j + 1]
            d[j + 1] = c * d[j + 1]
            # left rotation: rows (j, j+1), zero the (j+1, j) bulge
            c, s = host_givens(d[j], bulge)
            cl[j] = c
            sl[j] = s
            d[j] = c * d[j] + s * bulge
            f[j], d[j + 1] = plane_update(f[j], d[j + 1], c, s, -1.0)
            if j < hi - 1:
                bulge2 = s * f[j + 1]
                f[j + 1] = c * f[j + 1]
                y = f[j]
                z = bulge2
        wcl.append(cl)
        wsl.append(sl)
        wcr.append(cr)
        wsr.append(sr)

    return pack(True)
