"""Wrapper of the CUDA accumulated kernel (``csrc/rotseq_mxu.cu``).

Counterpart of ``repro.kernels.rotseq_mxu.kernel.rotseq_mxu_pallas``.
On a CPU tensor it runs the plain version; on a CUDA tensor it launches
the kernel or raises, and never falls back.  ``LAUNCHES`` counts
launches, and with :mod:`repro_torch.obs` on each launch also bumps
``kernels.rotseq_mxu.launches`` at the same line.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch import obs
from repro_torch.kernels import _build
from repro_torch.kernels.limits import MXU_MAX_W

from .ref import rotseq_mxu_ref

__all__ = ["rotseq_mxu", "traffic_bytes", "LAUNCHES"]

LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def traffic_bytes(M: int, T: int, n_b: int, k_b: int,
                  itemsize: int = 4) -> int:
    """Bytes one launch (one band) moves through memory: the fresh
    stream ``(M, T·n_b)`` read and the result written once, the carry
    ``(M, k_b)`` read once and the ``T`` factors ``(w, w)`` read once.
    A row's carry stays on chip across the band's tiles."""
    w = n_b + k_b
    return (2 * M * T * n_b + M * k_b + T * w * w) * itemsize


def _lib():
    fn = _build.load().rotseq_mxu_f32
    fn.argtypes = [_P] * 4 + [_I] * 5 + [_P]
    fn.restype = _I
    return fn


def rotseq_mxu(fresh, Q, init):
    """Sweep one band using tile factors ``Q`` (T, w, w).

    Args:
      fresh: ``(m, T * n_b)`` fresh column stream, natural layout.
      Q: ``(T, w, w)`` accumulated tile factors, ``w = k_b + n_b``.
      init: ``(m, k_b)`` initial carry.

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
    for name, x, shape in (("fresh", fresh, (M, T * n_b)),
                           ("Q", Q, (T, w, w)), ("init", init, (M, k_b))):
        if x.device != dev or x.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32 on {dev}, got "
                            f"{x.dtype} on {x.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {shape}, got "
                             f"{tuple(x.shape)}")
    if n_b < 1 or w > MXU_MAX_W:
        raise ValueError(f"n_b + k_b = {w}: the kernel takes tiles of "
                         f"width at most {MXU_MAX_W}")
    # the kernel reads Q through a TMA descriptor, whose row stride must
    # be a multiple of 16 bytes: pad a narrow factor with zeros
    ldq = -(-w // 4) * 4
    if ldq != w:
        Q = F.pad(Q, (0, ldq - w, 0, ldq - w))
    fn = _lib()
    out = torch.empty_like(fresh)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(fresh.data_ptr(), Q.data_ptr(), init.data_ptr(),
                out.data_ptr(), T, n_b, k_b, M, ldq, stream)
    if rc != 0:
        raise RuntimeError(f"rotseq_mxu launch failed: CUDA error {rc}")
    LAUNCHES += 1
    obs.inc("kernels.rotseq_mxu.launches")
    return out
