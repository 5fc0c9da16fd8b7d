"""Plain PyTorch version of the wavefront kernel (packed layout).

The CPU path of :func:`repro_torch.kernels.rotseq.kernel.rotseq_wave`,
and what the CUDA kernel is held against, bit for bit, on the card: the
blocked sweep of :func:`repro_torch.core.blocked.rot_sequence_blocked`
at the kernel's ``k_b``.  Its result does not depend on the tile width
``n_b`` (the sweep's pad planes reach every output column's cone at any
width), which only sets how the plain version cuts its work.
"""
from __future__ import annotations

from repro_torch.core.blocked import rot_sequence_blocked

__all__ = ["rotseq_wave_ref"]


def rotseq_wave_ref(AT, Cw, Sw, Gw, *, k_b: int = 16, n_b=None):
    """Same arguments and result as ``rotseq_wave``."""
    A = rot_sequence_blocked(AT.t(), Cw.t(), Sw.t(),
                             n_b=64 if n_b is None else n_b, k_b=k_b,
                             G=Gw.t())
    return A.t().contiguous()
