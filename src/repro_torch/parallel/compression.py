"""Gradient compression for cross-node communication.

Mirror of :mod:`repro.parallel.compression`.  ``compressed_psum``
quantizes a tensor to int8 (per-chunk scales) before an all-reduce over
a ``torch.distributed`` process group: on slow links the 4x volume
reduction outweighs the quantization noise, which *error feedback*
(:func:`error_feedback_update`, the residual carried to the next step)
suppresses further.

``compress_lowrank`` is the rank-r alternative for 2D gradients: a
Golub-Kahan SVD (:func:`repro_torch.eig.svd_givens`, singular vectors
accumulated through the rotation-sequence plans, on the card the
rotation kernels) truncated to rank ``r`` sends ``r (m + n)`` floats
instead of ``m n``, with the same error feedback
(:func:`lowrank_error_feedback`).

As in the reference, quantized values from different ranks cannot be
summed (their scales differ), so each rank sums its dequantized values;
the wire accounting (:func:`wire_bytes`) is the int8 payload plus the
float32 scales.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["quantize_for_allreduce", "dequantize_after_allreduce",
           "compressed_psum", "error_feedback_update", "wire_bytes",
           "svd_lowrank", "compress_lowrank", "decompress_lowrank",
           "lowrank_error_feedback", "lowrank_wire_bytes"]

_CHUNK = 256


def quantize_for_allreduce(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 payload ``(chunks, 256)`` + float32 per-chunk scales."""
    flat = x.reshape(-1)
    pad = (-flat.shape[0]) % _CHUNK
    blocks = F.pad(flat, (0, pad)).reshape(-1, _CHUNK)
    scale = torch.clamp(blocks.abs().amax(dim=1, keepdim=True) / 127.0,
                        min=1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale[:, 0]


def dequantize_after_allreduce(q, scale, shape):
    blocks = q.to(torch.float32) * scale[:, None]
    n = 1
    for d in shape:
        n *= d
    return blocks.reshape(-1)[:n].reshape(shape)


def compressed_psum(x, group=None):
    """Sum over ``group`` (a process group, a one-dimensional
    ``DeviceMesh``, or ``None``: the default group) of each rank's
    int8-round-tripped ``x``: gloo on the host, NCCL on the card."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import DeviceMesh

    if isinstance(group, DeviceMesh):
        group = group.get_group()
    q, s = quantize_for_allreduce(x)
    xq = dequantize_after_allreduce(q, s, x.shape)
    tdist.all_reduce(xq, op=tdist.ReduceOp.SUM, group=group)
    return xq


def error_feedback_update(grad, residual):
    """EF: quantize (grad + residual); return (compressed, new residual)."""
    total = grad + residual
    q, s = quantize_for_allreduce(total)
    sent = dequantize_after_allreduce(q, s, grad.shape)
    return sent, total - sent


def wire_bytes(x) -> int:
    """Bytes on the wire for the compressed format (vs 4 a float32)."""
    n = x.numel()
    chunks = -(-n // _CHUNK)
    return n + 4 * chunks  # int8 payload + fp32 scales


# --------------------------------------------------------------- low-rank --

def svd_lowrank(W, rank: int, *, apply_method: str = "auto",
                k_delay: int = 32):
    """Truncated SVD of a 2D tensor via the rotation-sequence SVD solver.

    Returns ``(U_r, s_r, Vt_r)`` with ``U_r (m, r)``, ``s_r (r,)``,
    ``Vt_r (r, n)``, on ``W``'s device: the best rank-``r``
    approximation's factors.  ``apply_method``/``k_delay`` reach the
    plans that accumulate the singular vectors (see ``repro_torch.eig``).
    """
    from repro_torch.eig import svd_givens

    if W.dim() != 2:
        raise ValueError(f"svd_lowrank expects a 2D tensor, got "
                         f"{tuple(W.shape)}")
    r = min(int(rank), min(W.shape))
    U, s, Vt = svd_givens(W, apply_method=apply_method, k_delay=k_delay)
    return U[:, :r], s[:r], Vt[:r, :]


def compress_lowrank(W, rank: int, **svd_kw):
    """Rank-``r`` wire format for a 2D gradient: ``(P, Q)`` with
    ``P = U_r * s_r`` (m, r) and ``Q = Vt_r`` (r, n)."""
    U, s, Vt = svd_lowrank(W, rank, **svd_kw)
    return U * s[None, :], Vt


def decompress_lowrank(P, Q):
    return P @ Q


def lowrank_error_feedback(grad, residual, rank: int, **svd_kw):
    """EF-SGD with a low-rank code: compress ``grad + residual``; returns
    ``(sent, new_residual)``."""
    total = grad + residual
    P, Q = compress_lowrank(total, rank, **svd_kw)
    sent = decompress_lowrank(P, Q)
    return sent, total - sent


def lowrank_wire_bytes(shape, rank: int, itemsize: int = 4) -> int:
    """Bytes on the wire for the ``(P, Q)`` format."""
    m, n = shape
    r = min(int(rank), m, n)
    return itemsize * r * (m + n)
