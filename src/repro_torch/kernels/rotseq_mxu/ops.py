"""Host wrapper of the accumulated kernel: factors, band loop, unpacking.

Mirror of ``repro.kernels.rotseq_mxu.ops``.  Per band of ``k_b`` waves
it builds the ``(w, w)`` factors of the band's rotation tiles
(:func:`band_factors`: on the card one launch of the fused batched
kernel over all tiles of the band, each tile one request on an identity
target) and launches one accumulated kernel over the carry/fresh
stream.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.core.accumulate import accumulate_tile_factors
from repro_torch.core.blocked import num_tiles, pack_sheared
from repro_torch.kernels.rotseq_batched.kernel import rotseq_batched

from .kernel import rotseq_mxu, traffic_bytes

__all__ = ["rot_sequence_mxu", "band_factors", "batched_band_factors",
           "band_panels", "band_windows", "band_inputs_natural"]


def band_panels(C, S, p0: int, k_b: int, n_b: int, T: int, *,
                reflect: bool = False, G=None):
    """The tiles of band ``[p0, p0 + k_b)`` as wave-major panels of the
    fused batched kernel, one request a tile.

    Tile ``t``'s local wave ``p`` acts on local column pairs ``j = k_b -
    1 - p + jj``, ``jj < n_b``: plane ``Ct[t, jj, p]`` of
    :func:`~repro_torch.core.blocked.pack_sheared`, which is plane
    ``t * n_b + j - (k_b - 1)`` of wave ``p0 + p`` for every ``p``.  So
    the panels are windows of one padded wave-major band: returns
    ``(C, S, G)`` ``(T, k_b, w - 1)``, ``w = n_b + k_b``, with ``C[t, p,
    j] = C[t * n_b + j - (k_b - 1), p0 + p]`` and the exact no-op ``c =
    1, s = 0, g = -1`` past the waves' ends.  The kernel applies only
    ``j`` in ``[k_b - 1 - p, k_b - 1 - p + n_b)`` (:func:`band_windows`);
    the entries around that window belong to the neighbouring tiles.
    """
    J, k = C.shape
    kw = min(k_b, k - p0)
    L = T * n_b + k_b - 1
    pad = (k_b - 1, L - (k_b - 1) - J, 0, k_b - kw)
    arrays = [(C, 1.0), (S, 0.0)]
    if G is not None or reflect:
        arrays.append((torch.ones_like(C) if G is None else G, -1.0))
    out = []
    for x, value in arrays:
        band = F.pad(x[:, p0:p0 + kw].t(), pad, value=value)  # (k_b, L)
        out.append(band.unfold(1, n_b + k_b - 1, n_b).transpose(0, 1)
                   .contiguous())
    if len(out) == 2:   # every plane a rotation, the padding too
        out.append(_band_constants(T, n_b, k_b, C.dtype, C.device)[3])
    return tuple(out)


def band_windows(T: int, n_b: int, k_b: int, device):
    """``(starts, counts)`` ``(T, k_b)`` int32 of :func:`band_panels`:
    wave ``p`` of every tile is live on ``n_b`` planes from ``k_b - 1 -
    p``."""
    return _band_constants(T, n_b, k_b, torch.float32,
                           torch.device(device))[1:3]


@functools.lru_cache(maxsize=16)
def _band_constants(T: int, n_b: int, k_b: int, dtype, device):
    """What every band of one tiling shares, made once a process (a
    band's host calls pace the application): the identity targets ``(T,
    w, w)``, the windows of :func:`band_windows` and the sign panel of
    plain rotations ``(T, k_b, w - 1)``.  Read only, never written."""
    w = n_b + k_b
    eye = torch.eye(w, dtype=dtype, device=device).expand(T, w, w)
    starts = torch.arange(k_b - 1, -1, -1, dtype=torch.int32, device=device)
    counts = torch.full((T, k_b), n_b, dtype=torch.int32, device=device)
    signs = torch.full((T, k_b, w - 1), -1.0, dtype=dtype, device=device)
    return (eye.contiguous(), starts.expand(T, k_b).contiguous(), counts,
            signs)


def batched_band_factors(C, S, p0: int, k_b: int, n_b: int, T: int, *,
                         reflect: bool = False, G=None):
    """The band's tile factors ``Q_t = I_w · tile_t`` by one fused batched
    launch: every tile is a request of
    :func:`~repro_torch.kernels.rotseq_batched.kernel.rotseq_batched` on
    its own identity target (on a CPU tensor, its plain version).

    Equal to ``accumulate_tile_factors(*pack_sheared(...))`` under
    ``==``: only the sign of zeros may differ.  The batched kernel skips
    the no-op planes outside each wave's window, which ``apply_tile``
    multiplies through, and a multiplied-through identity turns a ``+0``
    entry into ``-0``; no other bit can differ, since both apply the same
    planes in an order that respects every dependency.
    """
    panels = band_panels(C, S, p0, k_b, n_b, T, reflect=reflect, G=G)
    eye, starts, counts, _ = _band_constants(T, n_b, k_b, C.dtype, C.device)
    # the kernel's packed layout holds each target transposed: the
    # identity is its own transpose, the result is Q_t^T, returned as the
    # transposed view Q (the half accumulated tier reads Q^T itself)
    QT, _ = rotseq_batched(eye, *panels, starts, counts)
    return QT.transpose(1, 2)


def band_factors(C, S, p0: int, k_b: int, n_b: int, T: int, *,
                 reflect: bool = False, G=None, dtype=torch.float32):
    """Tile factors ``(T, w, w)`` of band ``[p0, p0 + k_b)``, accumulated
    in ``dtype`` (the target's, as the reference accumulates them).

    On a CUDA tensor one launch of the fused batched kernel in ``dtype``
    (:func:`batched_band_factors` on the waves rounded to ``dtype``):
    contiguous in float32, and in bfloat16 and float16 the transposed
    view of the launch's ``Q^T``, which the half tier of the accumulated
    kernel reads as it is.  On a CPU tensor the eager plain version,
    :func:`accumulate_tile_factors` of the sheared tiles.
    """
    if C.device.type == "cuda":
        Q = batched_band_factors(
            C.to(dtype), S.to(dtype), p0, k_b, n_b, T, reflect=reflect,
            G=None if G is None else G.to(dtype))
        return Q.contiguous() if dtype == torch.float32 else Q
    tiles = pack_sheared(C, S, p0, k_b, n_b, T, reflect=reflect, G=G)
    return accumulate_tile_factors(*tiles, dtype=dtype)


def rot_sequence_mxu(A, C, S, *, n_b: int = 128, k_b: int = 128,
                     reflect: bool = False, G=None):
    """Apply ``(C, S)`` to ``A`` from the right via accumulated tiles.

    On a CUDA tensor every band is one launch of the fused batched
    kernel (its factors) and one of the accumulated kernel, both in the
    target's dtype (float32, bfloat16 or float16); on a CPU tensor the
    same bands run through their plain versions.

    With :mod:`repro_torch.obs` on, a call counts its planes and the
    bytes its accumulated launches move (:func:`~.kernel.traffic_bytes`
    a band); the kernel wrappers count the launches on the card (the
    factor launches under ``kernels.rotseq_batched.launches``), and on
    the CPU this call counts one, as the reference counts in interpret
    mode.
    """
    m, n = A.shape
    J, k = C.shape
    if J != n - 1:
        raise ValueError(f"waves {tuple(C.shape)} do not fit A {(m, n)}")
    n_b = min(n_b, max(8, n))
    T = num_tiles(n, n_b, k_b)
    if obs.enabled() and not obs.traced(A):
        if A.device.type == "cpu":   # the plain version: one a call
            obs.inc("kernels.rotseq_mxu.launches")
        obs.inc("kernels.rotseq_mxu.planes_applied", J * k)
        obs.inc("kernels.rotseq_mxu.bytes_moved",
                -(-k // k_b) * traffic_bytes(m, T, n_b, k_b,
                                             A.element_size()))
    for p0 in range(0, k, k_b):
        Q = band_factors(C, S, p0, k_b, n_b, T, reflect=reflect, G=G,
                         dtype=A.dtype)
        fresh, init = band_inputs_natural(A, k_b, n_b, T)
        O = rotseq_mxu(fresh, Q, init)
        A = O[:, k_b - 1:k_b - 1 + n]
    return A.contiguous()


def band_inputs_natural(A, k_b: int, n_b: int, T: int):
    """``(fresh, init)`` of one band in the kernel's natural layout.

    ``band_inputs(A.t(), ...)`` transposed, built in one copy each:
    ``fresh`` ``(m, T * n_b)`` is ``A[:, 1:]`` padded with zero columns,
    ``init`` ``(m, k_b)`` is ``k_b - 1`` zero columns and ``A[:, :1]``.
    """
    m, n = A.shape
    fresh = F.pad(A[:, 1:], (0, T * n_b - (n - 1)))
    init = torch.cat([A.new_zeros((m, k_b - 1)), A[:, :1]], dim=1)
    return fresh, init
