"""Plane (Givens) rotation sequences: representation and generation.

Mirror of :mod:`repro.core.rotations`.  A sequence is stored as ``cos``
and ``sin`` of shape ``(n-1, k)``; rotation ``(j, p)`` acts on columns
``j, j+1`` of the target from the right, wave-major (all of wave ``p``,
ascending ``j``, before wave ``p+1``).  ``c = 1, s = 0, g = -1`` is a
no-op, which is how every blocked path pads its rotation grid.

Besides the canonical :func:`plane_update`, this module holds
:func:`sweep_planes`, the one vectorised plane loop every plain version
in the port is built on (see its docstring for why it is exact).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.sequence import RotationSequence, resolve_device

__all__ = [
    "RotationSequence",
    "plane_update",
    "sweep_planes",
    "step_schedule",
    "random_sequence",
    "givens",
    "identity_sequence",
    "sequence_to_dense",
]


def plane_update(x, y, c, s, g):
    """The canonical plane transform on one column pair.

    Every path of the port evaluates exactly this order::

        x' = c*x + s*y
        y' = g * (s*x - c*y)

    with ``g = -1`` for a rotation and ``+1`` for a reflector, and with
    every product and sum rounded on its own (no fused multiply-add).
    PyTorch's eager elementwise kernels round each operation, and the
    CUDA kernels spell it with ``__fmul_rn``/``__fadd_rn``/``__fsub_rn``,
    so the plain versions, the kernels and a float32 numpy loop agree
    bit for bit.  Works on tensors and on numpy arrays alike.
    """
    xn = c * x + s * y
    yn = g * (s * x - c * y)
    return xn, yn


def step_schedule(rows: np.ndarray, steps: np.ndarray):
    """Order planes by step: ``(order, rows, counts)`` for :func:`sweep_planes`.

    ``rows``/``steps`` give, for every plane of a flattened grid, the
    first row it touches and its step.  ``order`` is the stable argsort
    of ``steps`` (gather the plane values with it), ``rows`` the rows
    in that order and ``counts[d]`` the number of planes of step ``d``.
    Host-side numpy, so no device synchronisation is needed.
    """
    steps = np.asarray(steps).ravel()
    order = np.argsort(steps, kind="stable")
    counts = np.bincount(steps).tolist()
    return order, np.asarray(rows).ravel()[order], counts


def sweep_planes(XT, rows, c, s, g, counts, live=None):
    """Apply planes to row pairs ``(r, r+1)`` of ``XT`` in place, step by step.

    ``rows``, ``c``, ``s``, ``g`` list the planes sorted by step (``c``
    etc. may carry leading batch dimensions matching ``XT``'s);
    ``counts[d]`` planes belong to step ``d``.  ``live`` (a boolean mask
    laid out like ``c``) marks the planes to apply: the others are
    skipped, leaving their rows untouched as a kernel that never visits
    them does (a multiplied-through identity would turn ``-0.0`` into
    ``+0.0`` and spread NaN).  The caller picks steps so
    that the planes of one step touch disjoint row pairs and every
    plane's predecessors (the planes before it in sequential order that
    share a row) lie in earlier steps.  Each row then sees the same
    operations on the same values as in the sequential loop, so the
    result equals that loop bit for bit, while one step of many planes
    costs a handful of tensor operations.

    For the whole ``(n-1, k)`` grid the step of ``(j, p)`` is ``j + 2p``
    (``n + 2k - 3`` steps); within a tile or band of the blocked scheme
    it is ``jj + p`` over the local pairs ``k_b - 1 - p + jj``.
    """
    rows1 = rows + 1
    start = 0
    for cnt in counts:
        stop = start + cnt
        r0, r1 = rows[start:stop], rows1[start:stop]
        x = XT[..., r0, :]
        y = XT[..., r1, :]
        xn, yn = plane_update(x, y, c[..., start:stop, None],
                              s[..., start:stop, None],
                              g[..., start:stop, None])
        if live is not None:
            keep = live[..., start:stop, None]
            xn = torch.where(keep, xn, x)
            yn = torch.where(keep, yn, y)
        XT[..., r0, :] = xn
        XT[..., r1, :] = yn
        start = stop
    return XT


def givens(a, b):
    """``(c, s)`` zeroing ``b`` against ``a``: ``[c s; -s c]ᵀ [a; b] = [r; 0]``.

    Safe at ``a = b = 0`` (returns the identity rotation).
    """
    r = torch.hypot(a, b)
    safe = r > 0
    rs = torch.where(safe, r, torch.ones_like(r))
    c = torch.where(safe, a / rs, torch.ones_like(r))
    s = torch.where(safe, b / rs, torch.zeros_like(r))
    return c, s


def random_sequence(n: int, k: int, *, generator: torch.Generator | None
                    = None, device="cuda",
                    dtype=torch.float32) -> RotationSequence:
    """Random rotation sequence: uniform angles in ``[0, 2pi)``.

    Angles are drawn in float64 on the host from ``generator`` (the
    global generator when ``None``) and moved to ``device``, so a seed
    gives the same sequence on every device.
    """
    device = resolve_device(device)
    theta = torch.rand((n - 1, k), generator=generator,
                       dtype=torch.float64) * (2.0 * math.pi)
    return RotationSequence(torch.cos(theta).to(device, dtype),
                            torch.sin(theta).to(device, dtype))


def identity_sequence(n: int, k: int, *, dtype=torch.float32,
                      device="cuda") -> RotationSequence:
    return RotationSequence.identity(n, k, dtype=dtype, device=device)


def sequence_to_dense(seq: RotationSequence,
                      reflect: bool | None = None) -> np.ndarray:
    """Accumulate the whole sequence into a dense ``n x n`` float64 matrix.

    ``A @ Q`` equals applying the sequence to ``A``.  Pure numpy, for
    tests.  ``reflect=None`` honours the sequence's ``reflect`` flag and
    ``sign`` array; an explicit boolean overrides both.
    """
    cos = seq.cos.detach().cpu().double().numpy()
    sin = seq.sin.detach().cpu().double().numpy()
    sign = seq.sign
    if reflect is None:
        reflect = bool(seq.reflect)
    else:
        sign = None
    if sign is not None:
        g_all = sign.detach().cpu().double().numpy()
    else:
        g_all = np.full(cos.shape, 1.0 if reflect else -1.0)
    n = cos.shape[0] + 1
    q = np.eye(n)
    for p in range(cos.shape[1]):
        for j in range(n - 1):
            x = q[:, j].copy()
            y = q[:, j + 1].copy()
            q[:, j], q[:, j + 1] = plane_update(x, y, cos[j, p], sin[j, p],
                                                g_all[j, p])
    return q
