"""Plain PyTorch rotary position embeddings (RoPE), and their tables.

Mirror of :mod:`repro.kernels.rope.ref`.  RoPE is the degenerate
planar-rotation sequence: one wave of disjoint rotations, dimension
pairs ``(i, i + d/2)`` of each head vector rotating by ``pos * theta_i``
(the half-split, "rotate_half", convention).  :func:`apply_rope_ref` is
the CPU path of :func:`repro_torch.kernels.rope.kernel.rope` and what the
CUDA kernel is held against, bit for bit, on the card.
"""
from __future__ import annotations

import torch

__all__ = ["rope_tables", "apply_rope_ref"]


def rope_tables(positions, head_dim: int, base: float = 10000.0,
                dtype=torch.float32):
    """cos/sin tables ``(len(positions), head_dim // 2)``.

    The angles are computed in float32 and the tables cast to ``dtype``.
    The inverse frequencies ``base ** (-i / half)`` are taken in float64
    and rounded once to float32: that agrees with the reference's float32
    power bit for bit at the configurations' widths, where torch's own
    float32 power differs in the last bit for a few ``i``.
    """
    half = head_dim // 2
    expo = -torch.arange(0, half, dtype=torch.float32,
                         device=positions.device) / half
    inv_freq = (base ** expo.double()).float()
    ang = positions.float()[:, None] * inv_freq[None, :]
    return torch.cos(ang).to(dtype), torch.sin(ang).to(dtype)


def apply_rope_ref(x, cos, sin):
    """Rotate ``x`` (..., seq, heads, head_dim) by per-position tables.

    ``cos``/``sin``: (seq, head_dim // 2).
    """
    half = x.shape[-1] // 2
    x1 = x[..., :half]
    x2 = x[..., half:]
    c = cos[..., :, None, :]
    s = sin[..., :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)
