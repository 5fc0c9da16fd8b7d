"""Public eigensolver / SVD entry points built on recorded rotations.

Mirror of :mod:`repro.eig.api`.  ``eigh_givens(A, method="qr"|"jacobi")``
and ``svd_givens(A)`` are analogues of ``torch.linalg.eigh`` /
``torch.linalg.svd`` whose eigen/singular-vector accumulation runs
through the rotation-sequence registry:

* ``method="qr"``: tridiagonalize (:mod:`.tridiag`), then implicit
  Wilkinson-shift QR (:mod:`.qr_shift`).  Both stages record their
  rotations on the host in float64; the basis ``V = Q_tri U_qr`` is the
  two recordings streamed through one :class:`DelayedRotationBuffer`
  seeded with the identity on the target device.  Eigenvalues come from
  the float64 recurrences, so their accuracy is the oracle's in every
  dtype; the vectors' is that of the application in the target dtype.
* ``method="jacobi"``: the round-robin solver of
  :mod:`repro_torch.core.jacobi`, its recorded reflector sequence
  applied through the same dispatch.

``svd_givens`` runs Golub-Kahan bidiagonalization and bidiagonal QR
(:mod:`.svd`) with one delayed buffer per singular-vector side.

A tensor input stays on its device; an array goes to ``device``, the
card by default.  The input's floating dtype is kept (float64 too: the
reference turns float64 into float32 when JAX's 64-bit mode is off,
torch has no such switch).  ``k_delay`` is the SS5.1 delay depth: how
many recorded waves are batched per planned application.
"""
from __future__ import annotations

import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.core.sequence import (RotationSequence, _as_tensor,
                                       resolve_device)

from .delayed import DelayedRotationBuffer
from .qr_shift import tridiag_qr
from .svd import bidiag_qr, bidiagonalize
from .tridiag import _host64, tridiagonalize

__all__ = ["EighResult", "SvdResult", "eigh_givens", "svd_givens"]


class EighResult(NamedTuple):
    eigenvalues: torch.Tensor   # (n,) ascending, like torch.linalg.eigh
    eigenvectors: torch.Tensor  # (n, n); column i pairs with eigenvalue i


class SvdResult(NamedTuple):
    U: torch.Tensor   # (m, k) left singular vectors, k = min(m, n)
    s: torch.Tensor   # (k,) descending, non-negative
    Vt: torch.Tensor  # (k, n) right singular vectors, transposed


def _target(A, device):
    """``(dtype, device)`` of the result: a tensor's own (``device``
    overrides), or the array's dtype on ``device``, the card by default.
    A dtype that is not floating becomes float32."""
    if isinstance(A, torch.Tensor):
        dtype = A.dtype
        dev = A.device if device is None else resolve_device(device)
    else:
        dtype = torch.from_numpy(np.empty(0, np.asarray(A).dtype)).dtype
        dev = resolve_device(device or "cuda")
    return (dtype if dtype.is_floating_point else torch.float32), dev


def eigh_givens(A, *, method: str = "qr", k_delay: int = 32,
                apply_method: str = "auto", autotune: bool = False,
                cycles: int = 8, tol: Optional[float] = None,
                max_sweeps: Optional[int] = None,
                device=None) -> EighResult:
    """Symmetric eigendecomposition via recorded rotation sequences.

    Args:
      A: symmetric ``(n, n)``, a tensor or an array.
      method: ``"qr"`` (tridiagonal QR, default) or ``"jacobi"``.
      k_delay: delayed-application batch depth (waves per flush).
      apply_method: dispatch method for the basis accumulation
        (``"auto"``: the registry's cost model).
      autotune: measure the candidate plans of the basis accumulation
        when it is first planned (the first flush, or the Jacobi
        application).
      cycles: Jacobi cycles (``method="jacobi"`` only).
      tol / max_sweeps: QR deflation threshold and sweep budget.
      device: where an array input goes (default the card); a tensor
        stays where it is unless ``device`` is given.

    Returns ``EighResult(eigenvalues, eigenvectors)`` with ascending
    eigenvalues, ``A @ V == V @ diag(w)`` to the dtype's accuracy.
    """
    n = A.shape[0]
    if tuple(A.shape) != (n, n):
        raise ValueError(f"eigh_givens expects square input, got "
                         f"{tuple(A.shape)}")
    dtype, dev = _target(A, device)
    if n == 0:
        return EighResult(torch.zeros((0,), dtype=dtype, device=dev),
                          torch.zeros((0, 0), dtype=dtype, device=dev))

    if method == "jacobi":
        from repro_torch.core.jacobi import jacobi_apply_basis, jacobi_eigh

        H = _as_tensor(A, dev).to(dtype)
        res = jacobi_eigh(H, cycles=cycles)
        V = jacobi_apply_basis(res, method=apply_method, autotune=autotune)
        w = res.eigenvalues
        order = torch.argsort(w, stable=True)
        return EighResult(w[order], V[:, order])
    if method != "qr":
        raise ValueError(f"unknown eigh method {method!r}; "
                         f"one of ('qr', 'jacobi')")

    tri = tridiagonalize(_host64(A))
    qr = tridiag_qr(tri.diag, tri.offdiag, tol=tol, max_sweeps=max_sweeps)
    _warn_unconverged("eigh_givens", qr.converged, qr.sweeps)
    buf = DelayedRotationBuffer(torch.eye(n, dtype=dtype, device=dev),
                                k_delay=k_delay, method=apply_method,
                                autotune=autotune)
    # V = Q_tri @ U_qr: both recordings share the (n-1, .) plane layout,
    # so they stream through the buffer as one composed sequence
    buf.push_sequence(RotationSequence(torch.from_numpy(tri.cos),
                                       torch.from_numpy(tri.sin)))
    buf.push_sequence(RotationSequence(torch.from_numpy(qr.cos),
                                       torch.from_numpy(qr.sin)))
    V = buf.value
    order = np.argsort(qr.eigenvalues, kind="stable")
    w = torch.from_numpy(qr.eigenvalues[order]).to(dtype).to(dev)
    return EighResult(w, V[:, torch.from_numpy(order).to(dev)])


def svd_givens(A, *, k_delay: int = 32, apply_method: str = "auto",
               autotune: bool = False, tol: Optional[float] = None,
               max_sweeps: Optional[int] = None,
               full_matrices: bool = False, device=None) -> SvdResult:
    """Golub-Kahan SVD via recorded rotation sequences.

    Returns ``SvdResult(U, s, Vt)`` in ``torch.linalg.svd(A,
    full_matrices=False)``'s conventions: descending non-negative ``s``,
    ``A ~= U @ diag(s) @ Vt``.  With ``full_matrices=True`` the trailing
    null-space columns of the tall factor are kept.  Placement and dtype
    as in :func:`eigh_givens`, and so is ``autotune``.
    """
    m, n = A.shape
    dtype, dev = _target(A, device)
    if m < n:
        r = svd_givens(A.T, k_delay=k_delay, apply_method=apply_method,
                       autotune=autotune, tol=tol, max_sweeps=max_sweeps,
                       full_matrices=full_matrices, device=device)
        return SvdResult(r.Vt.T, r.s, r.U.T)
    if n == 0:
        return SvdResult(torch.zeros((m, 0), dtype=dtype, device=dev),
                         torch.zeros((0,), dtype=dtype, device=dev),
                         torch.zeros((0, 0), dtype=dtype, device=dev))

    bd = bidiagonalize(_host64(A))
    qr = bidiag_qr(bd.diag, bd.superdiag, tol=tol, max_sweeps=max_sweeps)
    _warn_unconverged("svd_givens", qr.converged, qr.sweeps)

    def accumulate(size, *recordings):
        buf = DelayedRotationBuffer(
            torch.eye(size, dtype=dtype, device=dev), k_delay=k_delay,
            method=apply_method, autotune=autotune)
        for C, S in recordings:
            buf.push_sequence(RotationSequence(torch.from_numpy(C),
                                               torch.from_numpy(S)))
        return buf.value

    # left factor: bidiagonalization waves live on m-1 planes, QR waves
    # on n-1; embed the latter with identity padding below plane n-2
    U = accumulate(m, (bd.cos_left, bd.sin_left),
                   (_embed_planes(qr.cos_left, m - 1, 1.0),
                    _embed_planes(qr.sin_left, m - 1, 0.0)))
    V = accumulate(n, (bd.cos_right, bd.sin_right),
                   (qr.cos_right, qr.sin_right))

    # sign fix + descending sort are column operations on the accumulated
    # factors, not rotations
    vals = qr.values
    sgn = torch.from_numpy(np.where(vals < 0.0, -1.0, 1.0)).to(dtype).to(dev)
    order = torch.from_numpy(np.argsort(-np.abs(vals), kind="stable")).to(dev)
    s = torch.from_numpy(np.abs(vals)).to(dtype).to(dev)[order]
    Uk = (U[:, :n] * sgn[None, :])[:, order]
    Vk = V[:, order]
    if full_matrices and m > n:
        Uk = torch.cat([Uk, U[:, n:]], dim=1)
    return SvdResult(Uk, s, Vk.T)


def _warn_unconverged(who: str, converged: bool, sweeps: int) -> None:
    # values from a truncated run look plausible; make the truncation loud
    if not converged:
        warnings.warn(
            f"{who}: implicit-shift QR exhausted its sweep budget "
            f"({sweeps} sweeps) before full deflation; results are "
            f"approximate (raise max_sweeps, or check the input for "
            f"pathological structure)", RuntimeWarning, stacklevel=3)


def _embed_planes(C, planes: int, fill: float) -> np.ndarray:
    """Grow a ``(j, k)`` wave block to ``planes`` rows of no-op padding."""
    C = np.asarray(C, np.float64)
    if C.shape[0] == planes:
        return C
    out = np.full((planes, C.shape[1]), fill, np.float64)
    out[:C.shape[0], :] = C
    return out
