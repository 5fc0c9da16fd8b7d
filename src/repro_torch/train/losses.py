"""Losses: mirror of :mod:`repro.train.losses`."""
from __future__ import annotations

import torch

__all__ = ["softmax_cross_entropy"]


def softmax_cross_entropy(logits, labels):
    """Mean next-token CE + z-loss term (both float32).

    The label's log-probability is gathered (the reference reduces a
    masked row instead, which keeps vocab-sharded logits sharded under
    GSPMD; the value is the same).
    """
    lf = logits.float()
    last = lf.dim() - 1
    lse = torch.logsumexp(lf, dim=last)
    ll = torch.gather(lf, last, labels[..., None].long())[..., 0]
    ce = torch.mean(lse - ll)
    z = torch.mean(torch.square(lse))
    return ce, z
