"""Wrapper of the CUDA accumulated kernels (``csrc/rotseq_mxu.cu``,
``csrc/rotseq_mxu_half.cu``).

Counterpart of ``repro.kernels.rotseq_mxu.kernel.rotseq_mxu_pallas``.
On a CPU tensor it runs the plain version; on a CUDA tensor it launches
the kernel or raises, and never falls back.  float32 operands go to the
IEEE float32 tier on the CUDA cores (``rotseq_mxu_f32``), bfloat16 and
float16 ones to the half tier on the tensor cores (``rotseq_mxu_bf16``,
``rotseq_mxu_f16``: float32 sums, each result rounded to the operands'
dtype, as the reference's body computes them); float64 has no entry.
``LAUNCHES`` counts launches, ``DTYPE_LAUNCHES`` the same launches by
dtype, and with :mod:`repro_torch.obs` on each launch also bumps
``kernels.rotseq_mxu.launches`` at the same line.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.kernels import _build
from repro_torch.kernels.limits import MXU_HALF_VEC, MXU_MAX_W, round_up

from .ref import rotseq_mxu_ref

__all__ = ["rotseq_mxu", "traffic_bytes", "LAUNCHES", "DTYPE_LAUNCHES",
           "ENTRY"]

LAUNCHES = 0
DTYPE_LAUNCHES = {"float32": 0, "bfloat16": 0, "float16": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
# the library's entry of each operand dtype
ENTRY = {torch.float32: "rotseq_mxu_f32", torch.bfloat16: "rotseq_mxu_bf16",
         torch.float16: "rotseq_mxu_f16"}
_FN = {}


def traffic_bytes(M: int, T: int, n_b: int, k_b: int,
                  itemsize: int = 4) -> int:
    """Bytes one launch (one band) moves through memory: the fresh
    stream ``(M, T·n_b)`` read and the result written once, the carry
    ``(M, k_b)`` read once and the ``T`` factors ``(w, w)`` read once.
    A row's carry stays on chip across the band's tiles."""
    w = n_b + k_b
    return (2 * M * T * n_b + M * k_b + T * w * w) * itemsize


def _entry(dtype):
    """The library's entry for operands of ``dtype``; raises ``TypeError``
    for a dtype the kernel has no entry for."""
    if dtype not in ENTRY:
        raise TypeError(f"the accumulated kernel takes "
                        f"{', '.join(map(str, ENTRY))}, not {dtype}")
    fn = _FN.get(dtype)
    if fn is None:
        fn = getattr(_build.load(), ENTRY[dtype])
        fn.argtypes = [_P] * 4 + [_I] * 5 + [_P]
        fn.restype = _I
        _FN[dtype] = fn
    return fn


def rotseq_mxu(fresh, Q, init):
    """Sweep one band using tile factors ``Q`` (T, w, w).

    Args:
      fresh: ``(m, T * n_b)`` fresh column stream, natural layout;
        float32, bfloat16 or float16 on the card.
      Q: ``(T, w, w)`` accumulated tile factors, ``w = k_b + n_b``;
        contiguous, or for bfloat16 and float16 also the transposed
        view of a contiguous ``Q^T`` (as :func:`~.ops.band_factors`
        leaves it), which the half tier reads without a copy.
      init: ``(m, k_b)`` initial carry.  ``Q`` and ``init`` in
        ``fresh``'s dtype.

    Returns ``(m, T * n_b)`` with ``O[:, i] = A_final[:, i - k_b + 1]``.
    """
    global LAUNCHES
    dev = fresh.device
    if dev.type == "cpu":
        return rotseq_mxu_ref(fresh, Q, init)
    if dev.type != "cuda":
        raise ValueError(f"rotseq_mxu runs on cuda or cpu, not {dev}")
    T, w, _ = Q.shape
    M, k_b = init.shape
    n_b = w - k_b
    half = fresh.dtype != torch.float32
    for name, x, shape in (("fresh", fresh, (M, T * n_b)),
                           ("Q", Q, (T, w, w)), ("init", init, (M, k_b))):
        if x.device != dev or x.dtype != fresh.dtype:
            raise TypeError(f"{name}: the kernel takes {fresh.dtype} on "
                            f"{dev}, got {x.dtype} on {x.device}")
        # the half tier also takes Q as a transposed view of Q^T
        laid_out = x.is_contiguous() or (
            half and name == "Q" and x.transpose(1, 2).is_contiguous())
        if tuple(x.shape) != shape or not laid_out:
            raise ValueError(f"{name}: expected contiguous {shape}, got "
                             f"{tuple(x.shape)}")
    if n_b < 1 or w > MXU_MAX_W:
        raise ValueError(f"n_b + k_b = {w}: the kernel takes tiles of "
                         f"width at most {MXU_MAX_W}")
    fn = _entry(fresh.dtype)
    if fresh.dtype == torch.float32:
        # the kernel reads Q through a TMA descriptor, whose row stride
        # must be a multiple of 16 bytes: pad a narrow factor with zeros
        ldq = -(-w // 4) * 4
        if ldq != w:
            Q = F.pad(Q, (0, ldq - w, 0, ldq - w))
    else:
        # the half tier reads Q^T (wgmma's K-major B) through TMA: the
        # factor launch's own Q^T where Q is a view of it; TMA reads from
        # 16-byte aligned coordinates and strides, so where k_b or w is
        # ragged the fresh rows' columns move to kq and the rows to ldq
        kq = round_up(k_b, MXU_HALF_VEC)
        ldq = round_up(kq + n_b, MXU_HALF_VEC)
        Q = Q.transpose(1, 2)
        if kq != k_b or ldq != w:
            Q = torch.cat([F.pad(Q[..., :k_b], (0, kq - k_b)),
                           F.pad(Q[..., k_b:], (0, ldq - kq - n_b))], -1)
        Q = Q.contiguous()
    out = torch.empty_like(fresh)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(fresh.data_ptr(), Q.data_ptr(), init.data_ptr(),
                out.data_ptr(), T, n_b, k_b, M, ldq, stream)
    if rc != 0:
        raise RuntimeError(f"rotseq_mxu launch failed: CUDA error {rc}")
    LAUNCHES += 1
    DTYPE_LAUNCHES[str(fresh.dtype).replace("torch.", "")] += 1
    obs.inc("kernels.rotseq_mxu.launches")
    return out
