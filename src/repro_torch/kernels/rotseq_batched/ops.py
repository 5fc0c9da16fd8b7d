"""Host wrapper of the fused batched kernel: live windows, packing, unpacking.

Mirror of ``repro.kernels.rotseq_batched.ops``.  Materialises the sign
grid, computes every wave's live-plane window (:func:`wave_windows`) on
the tensor's own device with no host synchronisation, transposes the
targets once into the packed ``(b, n, m)`` layout and the panels into
wave-major ``(bs, K, n-1)``, and launches one kernel for the whole
batch.  Rows need no padding: the kernel masks the ragged last block.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.ref import sign_grid

from .kernel import rotseq_batched, traffic_bytes

__all__ = ["rot_sequence_batched", "wave_windows", "count_live_planes"]


def wave_windows(C, S, G):
    """Per-wave live-plane windows ``(starts, counts)``, int32 ``(bs, K)``.

    ``C``/``S``/``G`` are ``(bs, n-1, K)``.  A plane is dead (exactly
    skippable) iff it is the identity rotation ``c = 1, s = 0, g = -1``;
    a padded reflector ``diag(1, -1)`` is live.  Each wave's live planes
    are reduced to their contiguous hull ``[start, start + count)``: the
    ``pad_to`` tails and the ``seq.T`` staircase triangles fall outside
    it, and dead planes inside it are applied as exact no-ops.

    Skipping is exact for finite targets free of ``-0.0``: a
    multiplied-through identity computes ``0*x`` terms, which turn NaN
    or inf into NaN and ``-0.0`` into ``+0.0``, while the skip leaves
    them untouched.
    """
    live = ~((C == 1) & (S == 0) & (G < 0))              # (bs, J, K)
    any_live = live.any(dim=1)                            # (bs, K)
    flags = live.to(torch.uint8)
    first = flags.argmax(dim=1)                           # first max wins
    last = live.shape[1] - 1 - flags.flip(1).argmax(dim=1)
    zero = torch.zeros_like(first)
    starts = torch.where(any_live, first, zero)
    counts = torch.where(any_live, last - first + 1, zero)
    return starts.to(torch.int32), counts.to(torch.int32)


def count_live_planes(seq) -> int:
    """Hull-plane count of one sequence under :func:`wave_windows` (a
    test helper: the skip witness is held against the kernel's own
    liveness rule)."""
    C = seq.cos[None]
    G = sign_grid(C, seq.reflect, None if seq.sign is None else seq.sign[None])
    _, counts = wave_windows(C, seq.sin[None], G)
    return int(counts.sum())


def rot_sequence_batched(A, C, S, *, reflect: bool = False, G=None,
                         return_planes: bool = False):
    """Apply shared or per-request wave stacks to a batch of targets.

    Args:
      A: targets ``(b, m, n)``, or one ``(m, n)`` target.
      C, S: waves, shared ``(n-1, K)`` or stacked ``(b, n-1, K)``.
      G: optional per-entry signs shaped like ``C``; ``reflect`` marks
        an all-reflector stack when ``G`` is ``None``.
      return_planes: also return the kernel's ``(b, R)`` int32 count of
        planes applied per row block (the skip witness).

    On a CUDA tensor this is one launch of the fused kernel; on a CPU
    tensor the same launch runs through its plain version.

    With :mod:`repro_torch.obs` on, a call counts the planes its windows
    apply and skip, as the reference does, and the bytes the kernel
    moves (:func:`~.kernel.traffic_bytes`); the kernel wrapper counts the
    launch on the card, and on the CPU this call counts one.  On the card
    the planes are read after the launch, so the read waits for the
    kernel rather than holding its launch back.
    """
    single = A.ndim == 2
    if single:
        A = A[None]
    b, m, n = A.shape
    if C.ndim == 2:
        C, S = C[None], S[None]
        G = None if G is None else G[None]
    bs, J, K = C.shape
    if J != n - 1 or bs not in (1, b):
        raise ValueError(f"waves {tuple(C.shape)} do not fit targets "
                         f"{(b, m, n)}")
    G = sign_grid(C, reflect, G)
    starts, counts = wave_windows(C, S, G)
    AT = A.transpose(1, 2).contiguous()
    Cw, Sw, Gw = (x.to(A.dtype).transpose(1, 2).contiguous()
                  for x in (C, S, G))
    out, planes = rotseq_batched(AT, Cw, Sw, Gw, starts, counts)
    if obs.enabled() and not obs.traced(A):
        _account(A, bs, J, K, counts)
    out = out.transpose(1, 2).contiguous()
    if single:
        out = out[0]
    return (out, planes) if return_planes else out


def _account(A, bs: int, J: int, K: int, counts) -> None:
    """Count one call: the hull planes every target applies (shared
    waves replay their windows on every target) and the rest of the
    grid as skipped, as the reference's ``_record_launch`` does."""
    b, n, m = A.shape[0], A.shape[2], A.shape[1]
    applied = int(counts.sum()) * (b // bs)
    if A.device.type == "cpu":   # the plain version: one a call
        obs.inc("kernels.rotseq_batched.launches")
    obs.inc("kernels.rotseq_batched.planes_applied", applied)
    obs.inc("kernels.rotseq_batched.planes_skipped", J * K * b - applied)
    obs.inc("kernels.rotseq_batched.bytes_moved",
            traffic_bytes(b, bs, n, m, K, A.element_size()))
