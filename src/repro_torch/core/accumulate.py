"""Accumulated (GEMM) application of rotation sequences — paper's ``rs_gemm``.

Mirror of :mod:`repro.core.accumulate`.  Each parallelogram tile of a
band is accumulated into a dense orthogonal factor ``Q_t`` of size
``w x w`` (``w = k_b + n_b``) by applying the tile to the identity; the
sweep over ``A`` then becomes a chain of ``(m, w) @ (w, w)`` products
with a carry of ``k_b`` columns.

:func:`accumulate_tile_factors` runs the tiles of a band together and
applies all planes of one ``jj + p`` in one step, so a band of
``n_b = k_b = 128`` costs 255 steps instead of 16k sequential planes.
In the registry's cost split the factors are per-sequence *setup* and
the GEMM sweep is per-row *stream*.
"""
from __future__ import annotations

import torch

from ..compat import ieee_float32
from .blocked import band_inputs, apply_tile, num_tiles, pack_sheared

__all__ = [
    "accumulate_tile_factors",
    "apply_band_accumulated",
    "sweep_band_accumulated",
    "rot_sequence_accumulated",
]


def accumulate_tile_factors(Ct, St, Gt, *, dtype=torch.float32):
    """Accumulate sheared tiles ``(T, n_b, k_b)`` into factors ``(T, w, w)``.

    ``X_out = X_in @ Q_t`` for each tile, so ``Q_t = apply_tile(I)``.
    """
    T, n_b, k_b = Ct.shape
    w = k_b + n_b
    eye = torch.eye(w, dtype=dtype, device=Ct.device).expand(T, w, w)
    return apply_tile(eye, Ct, St, Gt).contiguous()


def sweep_band_accumulated(init, fresh, Q):
    """Plain version of one accumulated band, natural layout.

    ``init`` ``(m, k_b)`` is the initial carry, ``fresh`` ``(m, T*n_b)``
    the fresh column stream and ``Q`` ``(T, w, w)`` the tile factors.
    Per tile ``Y = [carry | fresh_t] @ Q_t``; the first ``n_b`` columns
    of ``Y`` are emitted and the last ``k_b`` carried.  Returns ``O``
    ``(m, T*n_b)`` with ``O[:, i] = A_final[:, i - (k_b - 1)]``.
    """
    T, w, _ = Q.shape
    k_b = init.shape[1]
    n_b = w - k_b
    carry, out = init, []
    with ieee_float32():
        for t in range(T):
            X = torch.cat([carry, fresh[:, t * n_b:(t + 1) * n_b]], dim=1)
            Y = X @ Q[t].to(X.dtype)
            out.append(Y[:, :n_b])
            carry = Y[:, n_b:]
    return torch.cat(out, dim=1)


def apply_band_accumulated(A, Q, *, k_b: int):
    """Sweep one band of ``A`` (m, n) through tile factors ``Q`` (T, w, w)."""
    T, w, _ = Q.shape
    n = A.shape[1]
    init, fresh = band_inputs(A.t(), k_b, w - k_b, T)
    O = sweep_band_accumulated(init.t(), fresh.t(), Q)
    return O[:, k_b - 1:k_b - 1 + n]


def rot_sequence_accumulated(A, C, S, *, n_b: int = 128, k_b: int = 128,
                             reflect: bool = False, G=None):
    """Full ``rs_gemm``-style application: accumulate tiles, apply as GEMMs."""
    m, n = A.shape
    J, k = C.shape
    if J != n - 1:
        raise ValueError(f"waves {tuple(C.shape)} do not fit A {(m, n)}")
    n_b = min(n_b, max(8, n))
    T = num_tiles(n, n_b, k_b)
    for p0 in range(0, k, k_b):
        Ct, St, Gt = pack_sheared(C, S, p0, k_b, n_b, T, reflect=reflect,
                                  G=G)
        Q = accumulate_tile_factors(Ct, St, Gt, dtype=A.dtype)
        A = apply_band_accumulated(A, Q, k_b=k_b)
    return A.contiguous()
