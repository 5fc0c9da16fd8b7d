"""Plain PyTorch version of the wavefront kernel (one band, packed layout).

The CPU path of :func:`repro_torch.kernels.rotseq.kernel.rotseq_wave`,
and what the CUDA kernel is held against, bit for bit, on the card.
"""
from __future__ import annotations

from repro_torch.core.blocked import sweep_band

__all__ = ["rotseq_wave_ref"]


def rotseq_wave_ref(ATfresh, Ct, St, Gt, init):
    """Same arguments and result as ``rotseq_wave``."""
    return sweep_band(init, ATfresh, Ct, St, Gt)
