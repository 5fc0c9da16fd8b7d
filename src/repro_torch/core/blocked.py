"""Blocked wavefront application of rotation sequences (paper SS2, SS5).

Mirror of :mod:`repro.core.blocked`, whose docstring derives the
coordinate bookkeeping the kernels share:

* diagonal index ``u = j + p``; tile ``t`` covers ``u in [t*n_b, (t+1)*n_b)``.
* inside a tile, wave ``p`` applies rotations at local column pairs
  ``(j_l, j_l + 1)`` for ``j_l = k_b - 1 - p + jj``, ``jj in [0, n_b)``.
* the rotation value for ``(t, jj, p)`` is ``C[t*n_b + jj - p, p0 + p]``,
  a sheared ("packed", paper SS4) view built by :func:`pack_sheared`.

One band sweeps a padded column stream ``P = [init | fresh]`` of
``k_b + T*n_b`` columns (``P[i]`` is column ``i - (k_b - 1)`` of the
target) with a carry of ``k_b`` columns from tile to tile.  Seen on
``P`` the band is the plane ``(u, p)`` on columns ``u - p + k_b - 1``
and ``+1`` for every ``u < T*n_b`` and ``p < k_b``, so its plain
version applies all planes of one ``u + p`` in one step
(:func:`sweep_band`) and equals the tile-by-tile order bit for bit.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.rotations import step_schedule, sweep_planes

__all__ = [
    "pack_sheared",
    "apply_tile",
    "apply_band",
    "sweep_band",
    "band_inputs",
    "rot_sequence_blocked",
    "num_tiles",
]


def num_tiles(n: int, n_b: int, k_b: int) -> int:
    """Number of diagonal tiles needed so every output column is emitted."""
    return math.ceil((n + k_b - 1) / n_b)


def pack_sheared(C, S, p0: int, k_b: int, n_b: int, T: int,
                 reflect: bool = False, G=None, u0: int = 0):
    """Shear-pack waves ``[p0, p0 + k_b)`` into aligned ``(T, n_b, k_b)`` tiles.

    ``Ct[t, jj, p] = C[u0 + t*n_b + jj - p, p0 + p]`` with no-op padding
    (``c = 1, s = 0, g = -1``) outside the valid ``(j, wave)`` range.
    ``Gt`` holds the per-entry sign; a padded *reflector* would not be a
    no-op, so padding is always a rotation.  ``u0`` offsets the
    diagonals (a column shard's range; it may be negative).  One
    vectorised gather, bitwise equal to the reference.
    """
    J, k = C.shape
    dev = C.device
    u = torch.arange(u0, u0 + T * n_b, device=dev)
    p = torch.arange(k_b, device=dev)
    jg = u[:, None] - p[None, :]
    pg = p0 + p
    valid = (jg >= 0) & (jg < J) & (pg < k)[None, :]
    jc = jg.clamp(0, J - 1)
    pc = pg.clamp(max=k - 1).expand_as(jc)
    one = torch.ones((), dtype=C.dtype, device=dev)
    Ct = torch.where(valid, C[jc, pc], one)
    St = torch.where(valid, S[jc, pc], torch.zeros_like(one))
    if G is not None:
        Gt = torch.where(valid, G[jc, pc], -one)
    elif reflect:
        Gt = torch.where(valid, one, -one)
    else:
        Gt = torch.full_like(Ct, -1.0)
    shape = (T, n_b, k_b)
    return Ct.reshape(shape), St.reshape(shape), Gt.reshape(shape)


def apply_tile(X, Ct, St, Gt):
    """Apply one parallelogram tile of rotations to ``X`` (..., m, k_b + n_b).

    ``Ct``/``St``/``Gt`` are sheared tiles ``(..., n_b, k_b)`` whose
    leading dimensions match ``X``'s.  Equal bit for bit to the
    sequential order (wave ``p`` ascending, ``jj`` ascending within a
    wave): the planes of one ``jj + p`` run as one step.
    """
    n_b, k_b = Ct.shape[-2:]
    jj = np.arange(n_b)[:, None]
    p = np.arange(k_b)[None, :]
    order, rows, counts = step_schedule(k_b - 1 - p + jj, jj + p)
    dev = X.device
    order = torch.from_numpy(order).to(dev)
    rows = torch.from_numpy(rows).to(dev)
    lead = Ct.shape[:-2]
    c, s, g = (x.to(X.dtype).reshape(*lead, n_b * k_b)[..., order]
               for x in (Ct, St, Gt))
    XT = X.transpose(-1, -2).contiguous()
    sweep_planes(XT, rows, c, s, g, counts)
    return XT.transpose(-1, -2)


def sweep_band(init, fresh, Ct, St, Gt):
    """Plain version of one band on the packed layout (columns as rows).

    ``init`` ``(k_b, m)`` is the initial carry, ``fresh`` ``(T*n_b, m)``
    the fresh column stream.  Returns ``O`` ``(T*n_b, m)`` with
    ``O[i] = A_final[:, i - (k_b - 1)]``: exactly what the wavefront
    kernel computes from the same inputs.
    """
    T, n_b, k_b = Ct.shape
    U = T * n_b
    u = np.arange(U)[:, None]
    p = np.arange(k_b)[None, :]
    order, rows, counts = step_schedule(u - p + k_b - 1, u + p)
    dev = fresh.device
    order = torch.from_numpy(order).to(dev)
    rows = torch.from_numpy(rows).to(dev)
    c, s, g = (x.to(fresh.dtype).reshape(-1)[order] for x in (Ct, St, Gt))
    P = torch.cat([init, fresh], dim=0)
    sweep_planes(P, rows, c, s, g, counts)
    return P[:U]


def band_inputs(AT, k_b: int, n_b: int, T: int):
    """Initial carry + fresh column stream for one band over packed ``AT``."""
    n, m = AT.shape
    init = torch.cat([AT.new_zeros((k_b - 1, m)), AT[:1]], dim=0)
    fresh = F.pad(AT[1:], (0, 0, 0, T * n_b - (n - 1)))
    return init, fresh


def apply_band(A, Ct, St, Gt):
    """Sweep one band of ``k_b`` waves over ``A`` (true column coordinates)."""
    T, n_b, k_b = Ct.shape
    n = A.shape[1]
    init, fresh = band_inputs(A.t(), k_b, n_b, T)
    O = sweep_band(init, fresh, Ct, St, Gt)
    return O[k_b - 1:k_b - 1 + n].t()


def rot_sequence_blocked(A, C, S, *, n_b: int = 64, k_b: int = 16,
                         reflect: bool = False, G=None):
    """Blocked wavefront algorithm (paper SS2 + SS5) in plain torch."""
    m, n = A.shape
    J, k = C.shape
    if J != n - 1:
        raise ValueError(f"waves {tuple(C.shape)} do not fit A {(m, n)}")
    n_b = min(n_b, max(8, n))  # don't tile wider than the matrix
    T = num_tiles(n, n_b, k_b)
    AT = A.t()
    for p0 in range(0, k, k_b):
        Ct, St, Gt = pack_sheared(C, S, p0, k_b, n_b, T, reflect=reflect,
                                  G=G)
        init, fresh = band_inputs(AT, k_b, n_b, T)
        AT = sweep_band(init, fresh, Ct, St, Gt)[k_b - 1:k_b - 1 + n]
    return AT.t().contiguous()
