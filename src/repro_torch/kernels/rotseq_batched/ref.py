"""Plain PyTorch version of the fused batched kernel.

The CPU path of :func:`repro_torch.kernels.rotseq_batched.kernel.
rotseq_batched`, and what the CUDA kernel is held against, bit for bit,
on the card.  It applies the whole ``(K, n-1)`` grid of every request
in the ``j + 2p`` step order (:func:`repro_torch.core.rotations.
sweep_planes`, ``n + 2K - 3`` vectorised steps over requests and rows)
and skips every plane outside its wave's ``[start, start + count)``
window, as the kernel leaves the row untouched there.  The kernel walks
bands of waves instead (steps ``j + 2i`` within a band); both orders
respect every plane's dependencies, so they agree to the bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.rotations import step_schedule, sweep_planes
from repro_torch.kernels.limits import row_blocks

__all__ = ["rotseq_batched_ref", "row_blocks"]


def rotseq_batched_ref(AT, C, S, G, starts, counts):
    """Same arguments and result as ``rotseq_batched``.

    ``AT`` ``(b, n, m)``; ``C``/``S``/``G`` wave-major panels ``(bs, K,
    n-1)`` with ``bs`` 1 (shared) or ``b``; ``starts``/``counts``
    ``(bs, K)`` int32.  Returns ``(out, planes)``: ``out`` ``(b, n, m)``
    and ``planes`` ``(b, R)`` int32, each row block's count of planes
    applied (the sum of its request's ``counts``).
    """
    b, n, m = AT.shape
    bs, K, J = C.shape
    R = row_blocks(m)
    dev = AT.device
    j = np.arange(J)[None, :]
    p = np.arange(K)[:, None]
    order, rows, steps = step_schedule(np.broadcast_to(j, (K, J)), j + 2 * p)
    order = torch.from_numpy(order).to(dev)
    rows = torch.from_numpy(rows).to(dev)
    c, s, g = (x.to(AT.dtype).reshape(bs, K * J)[:, order] for x in (C, S, G))
    jt = torch.arange(J, device=dev)
    live = ((jt >= starts[..., None])
            & (jt < (starts + counts)[..., None]))       # (bs, K, J)
    live = live.reshape(bs, K * J)[:, order]
    out = AT.clone()
    sweep_planes(out, rows, c, s, g, steps, live=live)
    total = counts.sum(dim=1, dtype=torch.int32)          # (bs,)
    planes = total[:, None].expand(b, R).contiguous()
    return out, planes
