"""Symmetric tridiagonalization recorded as an adjacent-plane rotation
sequence (the front half of the ``eigh_givens`` QR pipeline).

Mirror of :mod:`repro.eig.tridiag`.  Sweep ``t`` zeroes ``H[t+2:, t]``
bottom-up with rotations in adjacent planes ``(j, j+1)``,
``j = n-2, ..., t+1``, applied two-sidedly.  Sweep ``t``'s plane-``j``
rotation is recorded at wave

    ``p(j, t) = (n - 2 - j) + 2 t``

(the pipelined staircase: descending ``j`` within a sweep lands in
ascending waves, and overlapping planes of later sweeps land in later
waves), so the whole similarity transform is ``K = 2n - 5`` waves in
the paper's ``(n-1, K)`` layout.

Generation runs on the host in float64 numpy with the port's canonical
:func:`~repro_torch.core.rotations.plane_update`, the same operations in
the same order as the reference, so the recording equals the
reference's bit for bit.  Applying it is the flop-heavy part and goes
through :class:`repro_torch.eig.delayed.DelayedRotationBuffer`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.rotations import plane_update
from repro_torch.core.sequence import RotationSequence, resolve_device

__all__ = ["TridiagResult", "tridiagonalize", "tridiag_wave_count",
           "host_givens"]


def host_givens(a: float, b: float) -> tuple:
    """Host-side ``(c, s)`` zeroing ``b`` against ``a`` (identity at 0)."""
    r = float(np.hypot(a, b))
    if r == 0.0:
        return 1.0, 0.0
    return a / r, b / r


def tridiag_wave_count(n: int) -> int:
    """Waves of the pipelined-staircase packing: ``2n - 5`` (0 for n<3)."""
    return max(0, 2 * n - 5)


class TridiagResult(NamedTuple):
    """``T = Q^T H Q`` with ``Q`` recorded as adjacent-plane rotations."""

    diag: np.ndarray      # (n,)   float64 diagonal of T
    offdiag: np.ndarray   # (n-1,) float64 sub/super-diagonal of T
    cos: np.ndarray       # (n-1, K) float64 recorded sequence
    sin: np.ndarray       # (n-1, K)

    @property
    def n(self) -> int:
        return self.diag.shape[0]

    def sequence(self, dtype=None, device=None) -> RotationSequence:
        """The recorded transform as a port :class:`RotationSequence`.

        ``dtype`` defaults to float64; ``device`` to the card.
        """
        dev = resolve_device(device or "cuda")
        dt = torch.float64 if dtype is None else dtype
        return RotationSequence(torch.from_numpy(self.cos).to(dev, dt),
                                torch.from_numpy(self.sin).to(dev, dt))


def tridiagonalize(H) -> TridiagResult:
    """Reduce symmetric ``H`` to tridiagonal ``T`` via adjacent rotations.

    Applying the returned sequence to ``M`` computes ``M @ Q``; in
    particular ``Q = apply(I)`` satisfies ``Q^T H Q = T``.  ``H`` is a
    numpy array or a tensor (copied to the host in float64).
    """
    H = _host64(H)
    n = H.shape[0]
    if H.shape != (n, n):
        raise ValueError(f"tridiagonalize expects a square matrix, "
                         f"got {H.shape}")
    K = tridiag_wave_count(n)
    C = np.ones((max(n - 1, 0), K), np.float64)
    S = np.zeros((max(n - 1, 0), K), np.float64)
    for t in range(n - 2):
        for j in range(n - 2, t, -1):
            c, s = host_givens(H[j, t], H[j + 1, t])
            if s != 0.0:
                # columns < t of rows/cols >= t+1 are already zero, so the
                # update needs only the trailing t: slice; g = -1.0 gives
                # the rotation form -s*x + c*y bit for bit
                H[j, t:], H[j + 1, t:] = plane_update(
                    H[j, t:], H[j + 1, t:], c, s, -1.0)
                H[t:, j], H[t:, j + 1] = plane_update(
                    H[t:, j], H[t:, j + 1], c, s, -1.0)
            p = (n - 2 - j) + 2 * t
            C[j, p] = c
            S[j, p] = s
    d = np.diagonal(H).copy()
    e = np.diagonal(H, offset=1).copy() if n > 1 else np.zeros(0)
    return TridiagResult(d, e, C, S)


def _host64(A) -> np.ndarray:
    """A float64 numpy copy of ``A`` (a tensor on any device, or an
    array), which the host recurrences update in place."""
    if isinstance(A, torch.Tensor):
        return A.detach().to("cpu", torch.float64).numpy().copy()
    return np.array(A, dtype=np.float64)
