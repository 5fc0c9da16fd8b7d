"""Plain PyTorch version of the accumulated kernel (one band).

The CPU path of :func:`repro_torch.kernels.rotseq_mxu.kernel.rotseq_mxu`,
and what the CUDA kernel is held against on the card (float32 products
with TF32 off; the sums run in another order, so to a tolerance).  In
bfloat16 and float16 each tile's product is taken in float32 and rounded
to the operands' dtype once, as the reference's body does
(``dot(x, Q_t, preferred_element_type=float32).astype(x.dtype)``).
"""
from __future__ import annotations

import torch

from repro_torch.compat import ieee_float32
from repro_torch.core.accumulate import sweep_band_accumulated

__all__ = ["rotseq_mxu_ref"]

HALF = (torch.bfloat16, torch.float16)


def rotseq_mxu_ref(fresh, Q, init):
    """Same arguments and result as ``rotseq_mxu``."""
    if fresh.dtype not in HALF:
        return sweep_band_accumulated(init, fresh, Q)
    T, w, _ = Q.shape
    k_b = init.shape[1]
    n_b = w - k_b
    carry, out = init, []
    with ieee_float32():
        for t in range(T):
            X = torch.cat([carry, fresh[:, t * n_b:(t + 1) * n_b]], dim=1)
            Y = (X.float() @ Q[t].float()).to(fresh.dtype)
            out.append(Y[:, :n_b])
            carry = Y[:, n_b:]
    return torch.cat(out, dim=1)
