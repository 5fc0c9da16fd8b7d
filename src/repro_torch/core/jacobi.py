"""Jacobi eigensolver built on rotation/reflector sequences.

Mirror of :mod:`repro.core.jacobi`.  Adjacent-pivot Jacobi with the
Brent-Luk odd-even (round-robin) ordering: each wave zeroes all
disjoint adjacent pairs ``(j, j+1)`` (even ``j`` on even waves, odd
``j`` on odd waves) and swaps the pair, so every index pair becomes
adjacent over a cycle of ``n`` waves.  The rotation-then-swap
``G(c, s) @ PI`` is the 2x2 reflector ``[[c', s'], [s', -c']]`` with
``(c', s') = (-s, c)`` (paper SS8.4), so the pivots are recorded as a
sign-carrying sequence in the paper's ``(n-1, K)`` layout, and the
eigenvector basis is that sequence applied to the identity (paper
SS5.1, "delayed sequences of rotations").

The reference jits a ``fori_loop`` of ``K = cycles * n`` waves; here the
waves are a Python loop of torch operations on the input's device.
Float32 ``hypot`` is :func:`~repro_torch.core.sequence._hypot`
(``jnp.hypot``'s algorithm).  XLA contracts the plane form inside the
reference's loop, so ``C``, ``S`` and the eigenvalues agree with it to a
tolerance; the sign grid depends only on wave parity and agrees exactly.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .rotations import plane_update
from .sequence import RotationSequence, _as_tensor, _hypot

__all__ = ["JacobiResult", "jacobi_eigh", "jacobi_apply_basis"]


class JacobiResult(NamedTuple):
    eigenvalues: torch.Tensor  # (n,) unsorted (round-robin permuted)
    cos: torch.Tensor          # (n-1, K) recorded mixed sequence
    sin: torch.Tensor          # (n-1, K)
    sign: torch.Tensor         # (n-1, K) +1 reflector pivot / -1 no-op
    off_norm: torch.Tensor     # final off-diagonal Frobenius norm

    def rotation_sequence(self) -> RotationSequence:
        """The recorded pivots as a first-class ``RotationSequence``."""
        return RotationSequence(self.cos, self.sin, self.sign)


def _wave_pairs(n: int, parity: int, device=None) -> torch.Tensor:
    """Mask of valid pivot positions ``j`` for a wave of given parity."""
    j = torch.arange(n - 1, device=device)
    return (j % 2) == (parity % 2)


def _pivot_coeffs(H, parity: int):
    """Reflector coefficients zeroing ``H[j, j+1]`` for all disjoint pairs.

    Returns ``(c, s, g)`` of shape ``(n-1,)`` in the reflector
    convention; off-parity positions get the no-op rotation
    (``c=1, s=0, g=-1``).
    """
    n = H.shape[0]
    d = torch.diagonal(H)
    hjj, hkk = d[:-1], d[1:]
    hjk = torch.diagonal(H, offset=1)
    one = torch.ones_like(hjk)
    nz = hjk.abs() > 0
    # stable inner rotation (|theta| <= pi/4, Golub & Van Loan sym.schur2
    # in the G = [[c, -s], [s, c]] convention): tau = (a - d) / (2 b)
    b_safe = torch.where(nz, hjk, one)
    tau = (hjj - hkk) / (2.0 * b_safe)
    t = torch.sign(tau) / (tau.abs() + _hypot(one, tau))
    t = torch.where(tau == 0, one, t)
    c = 1.0 / _hypot(one, t)
    s = t * c
    # b == 0: the pair is already diagonal; the swap still runs through
    # the reflector, keeping the round-robin schedule intact
    c = torch.where(nz, c, one)
    s = torch.where(nz, s, 0 * one)
    # rotation-then-swap == reflector with (c', s') = (-s, c)
    valid = _wave_pairs(n, parity, H.device)
    cr = torch.where(valid, -s, one)
    sr = torch.where(valid, c, 0 * one)
    gr = torch.where(valid, one, -one)
    return cr, sr, gr


def jacobi_eigh(H0, *, cycles: int = 8) -> JacobiResult:
    """Symmetric eigendecomposition by round-robin adjacent Jacobi.

    Args:
      H0: symmetric ``(n, n)`` (float32/float64), a tensor (its device
        is used) or an array (placed on the card).
      cycles: full odd-even cycles; each cycle is ``n`` waves.  ~8
        cycles reach f32 machine precision for well-conditioned inputs.

    Returns ``JacobiResult`` with the recorded reflector sequence of
    ``K = cycles * n`` waves; ``V = apply(I, cos, sin, sign)`` satisfies
    ``V^T H0 V = diag(eigenvalues)``.
    """
    H = _as_tensor(H0, None).clone()
    n = H.shape[0]
    K = cycles * n
    dt, dev = H.dtype, H.device
    C = torch.ones((n - 1, K), dtype=dt, device=dev)
    S = torch.zeros((n - 1, K), dtype=dt, device=dev)
    G = torch.full((n - 1, K), -1.0, dtype=dt, device=dev)
    # the pair columns of a wave of each parity: n // 2 slots, the last
    # clamped onto n-2 (an off-parity no-op there), as the reference does
    pairs = [torch.clamp(par + 2 * torch.arange(n // 2, device=dev),
                         max=max(n - 2, 0)) for par in (0, 1)]
    for p in range(K):
        c, s, g = _pivot_coeffs(H, p)
        pj = pairs[p % 2]
        cc, ss, gg = c[pj][None, :], s[pj][None, :], g[pj][None, :]
        _col_pass(H, pj, cc, ss, gg)        # H @ R
        _col_pass(H.t(), pj, cc, ss, gg)    # R^T (H R), through the view
        C[:, p] = c
        S[:, p] = s
        G[:, p] = g
    off = torch.linalg.norm(H - torch.diag(torch.diagonal(H)))
    return JacobiResult(torch.diagonal(H).clone(), C, S, G, off)


def _col_pass(M, pj, c, s, g):
    """Plane updates on column pairs ``(pj, pj+1)`` of ``M``, in place:
    both columns gathered first, then written back as the reference's
    ``.at[:, pj].set`` and ``.at[:, pj+1].set``, in that order."""
    xn, yn = plane_update(M[:, pj], M[:, pj + 1], c, s, g)
    M[:, pj] = xn
    M[:, pj + 1] = yn


def jacobi_apply_basis(res: JacobiResult, M=None, *, method="auto",
                       n_b: int | None = None, k_b: int | None = None,
                       **kw):
    """Apply the recorded pivot sequence to ``M`` (default: identity).

    ``jacobi_apply_basis(res)`` returns the eigenvector matrix ``V``;
    ``jacobi_apply_basis(res, G)`` computes ``G @ V`` without forming
    ``V``.  Dispatch goes through ``seq.plan``, which also takes the
    other keywords (``autotune=True``, say): ``method="auto"`` lets the
    cost model pick the backend and tiles (the sign-carrying sequence
    restricts it to backends that take signs); a named method keeps the
    seed tiles ``n_b=64, k_b=16``.
    """
    seq = res.rotation_sequence()
    if M is None:
        M = torch.eye(seq.n, dtype=res.cos.dtype, device=res.cos.device)
    return seq.plan(like=M, method=method, n_b=n_b, k_b=k_b,
                    **kw).apply_direct(M)
