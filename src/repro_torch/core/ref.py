"""Reference implementations of rotation-sequence application.

Mirror of :mod:`repro.core.ref`.

``rot_sequence_numpy``        — Algorithm 1.2, pure numpy, float64: the oracle.
``rot_sequence_unoptimized``  — Algorithm 1.2 in torch, one plane at a time.
``rot_sequence_wavefront``    — Algorithm 1.3 in torch: anti-diagonal order.

The wavefront version applies every rotation ``(j, p)`` with the same
``d = j + 2p`` in one vectorised step: such rotations touch disjoint
column pairs, and each rotation's predecessors have a smaller ``d``, so
the result equals the sequential loop bit for bit in ``n + 2k - 3``
steps (:func:`repro_torch.core.rotations.sweep_planes`).  It is the
plain version of the whole main path on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.rotations import plane_update, step_schedule, \
    sweep_planes

__all__ = [
    "rot_sequence_numpy",
    "rot_sequence_unoptimized",
    "rot_sequence_wavefront",
    "reflector_sequence_numpy",
    "sign_grid",
]


def rot_sequence_numpy(A, C, S, reflect: bool = False,
                       G=None) -> np.ndarray:
    """Algorithm 1.2 in numpy (float64 accumulate). The test oracle."""
    A = np.array(A, dtype=np.float64, copy=True)
    C = np.asarray(C, dtype=np.float64)
    S = np.asarray(S, dtype=np.float64)
    n = A.shape[1]
    if C.shape[0] != n - 1:
        raise ValueError(f"waves {C.shape} do not fit A {A.shape}")
    if G is None:
        G = np.full(C.shape, 1.0 if reflect else -1.0)
    else:
        G = np.asarray(G, dtype=np.float64)
    for p in range(C.shape[1]):
        for j in range(n - 1):
            x = A[:, j].copy()
            y = A[:, j + 1].copy()
            A[:, j], A[:, j + 1] = plane_update(x, y, C[j, p], S[j, p],
                                                G[j, p])
    return A


def reflector_sequence_numpy(A, C, S) -> np.ndarray:
    """2x2 reflector variant (paper SS8.4): ``[[c, s], [s, -c]]`` per plane."""
    return rot_sequence_numpy(A, C, S, reflect=True)


def sign_grid(C, reflect: bool, G):
    """Per-entry sign tensor: ``G`` itself, or ``+1``/``-1`` everywhere."""
    if G is not None:
        return G
    return torch.full_like(C, 1.0 if reflect else -1.0)


def _check(A, C):
    if A.ndim != 2 or C.shape[0] != A.shape[1] - 1:
        raise ValueError(f"waves {tuple(C.shape)} do not fit A "
                         f"{tuple(A.shape)}")


def rot_sequence_unoptimized(A, C, S, reflect: bool = False, G=None):
    """Algorithm 1.2: wave ``p`` outer, plane ``j`` inner, one at a time."""
    _check(A, C)
    J, k = C.shape
    G = sign_grid(C, reflect, G)
    C, S, G = (x.to(A.dtype) for x in (C, S, G))
    A = A.clone()
    for p in range(k):
        for j in range(J):
            x = A[:, j].clone()
            y = A[:, j + 1].clone()
            A[:, j], A[:, j + 1] = plane_update(x, y, C[j, p], S[j, p],
                                                G[j, p])
    return A


def rot_sequence_wavefront(A, C, S, reflect: bool = False, G=None):
    """Algorithm 1.3: all rotations of one ``d = j + 2p`` per step."""
    _check(A, C)
    J, k = C.shape
    G = sign_grid(C, reflect, G)
    j = np.arange(J)[:, None]
    p = np.arange(k)[None, :]
    order, rows, counts = step_schedule(np.broadcast_to(j, (J, k)), j + 2 * p)
    dev = A.device
    order = torch.from_numpy(order).to(dev)
    rows = torch.from_numpy(rows).to(dev)
    c, s, g = (x.to(A.dtype).reshape(-1)[order] for x in (C, S, G))
    XT = A.t().contiguous()  # packed layout: columns of A are rows here
    sweep_planes(XT, rows, c, s, g, counts)
    return XT.t().contiguous()
