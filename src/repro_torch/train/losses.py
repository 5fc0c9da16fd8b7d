"""Losses: mirror of :mod:`repro.train.losses`."""
from __future__ import annotations

import torch

__all__ = ["softmax_cross_entropy"]


def softmax_cross_entropy(logits, labels):
    """Mean next-token CE + z-loss term (both float32).

    The label's log-probability is the sum of a row masked to the label,
    as the reference reduces it; the same value as a gather (one term and
    zeros), and under a mesh it stays on each device's rows, where a
    gather's backward builds zeros of the whole batch's logits on every
    device.
    """
    from torch.distributed.tensor import DTensor, Replicate
    lf = logits.float()
    last = lf.dim() - 1
    lse = torch.logsumexp(lf, dim=last)
    iota = torch.arange(lf.shape[-1], device=lf.device)
    if isinstance(labels, DTensor):
        iota = DTensor.from_local(
            iota, labels.device_mesh,
            [Replicate()] * labels.device_mesh.ndim, run_check=False)
    ll = torch.sum(torch.where(labels[..., None].long() == iota, lf, 0.0),
                   dim=last)
    ce = torch.mean(lse - ll)
    z = torch.mean(torch.square(lse))
    return ce, z
