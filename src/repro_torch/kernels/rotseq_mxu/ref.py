"""Plain PyTorch version of the accumulated kernel (one band).

The CPU path of :func:`repro_torch.kernels.rotseq_mxu.kernel.rotseq_mxu`,
and what the CUDA kernel is held against on the card (float32 products
with TF32 off; the sums run in another order, so to a tolerance).
"""
from __future__ import annotations

from repro_torch.core.accumulate import sweep_band_accumulated

__all__ = ["rotseq_mxu_ref"]


def rotseq_mxu_ref(fresh, Q, init):
    """Same arguments and result as ``rotseq_mxu``."""
    return sweep_band_accumulated(init, fresh, Q)
