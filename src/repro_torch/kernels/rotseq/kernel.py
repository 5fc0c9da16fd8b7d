"""Wrapper of the CUDA wavefront kernel (``csrc/rotseq_wave.cu``).

Counterpart of ``repro.kernels.rotseq.kernel.rotseq_wave_pallas``.  On a
CPU tensor it runs the plain version; on a CUDA tensor it launches the
kernel or raises, and never falls back.  ``LAUNCHES`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.limits import (SMEM_PER_BLOCK, WAVE_M_BLK,
                                        clamp_m_blk, wave_smem_bytes)

from .ref import rotseq_wave_ref

__all__ = ["rotseq_wave", "LAUNCHES"]

LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    fn = _build.load().rotseq_wave_f32
    fn.argtypes = [_P] * 6 + [_I] * 5 + [_P]
    fn.restype = _I
    return fn


def rotseq_wave(ATfresh, Ct, St, Gt, init):
    """Apply one band of ``k_b`` waves to the packed operand.

    Args:
      ATfresh: ``(T * n_b, m)`` fresh column stream, packed layout
        (``ATfresh[i] = A[:, i + 1]``, zero-padded).
      Ct, St, Gt: ``(T, n_b, k_b)`` sheared rotation tiles.
      init: ``(k_b, m)`` initial carry (``[0...0, A[:, 0]]``).

    On the card one thread carries one row of ``A``; a block has
    ``WAVE_M_BLK`` threads, fewer when ``A`` has fewer rows.

    Returns ``(T * n_b, m)`` with ``O[i] = A_final[:, i - (k_b - 1)]``.
    """
    global LAUNCHES
    dev = ATfresh.device
    if dev.type == "cpu":
        return rotseq_wave_ref(ATfresh, Ct, St, Gt, init)
    if dev.type != "cuda":
        raise ValueError(f"rotseq_wave runs on cuda or cpu, not {dev}")
    T, n_b, k_b = Ct.shape
    U, M = ATfresh.shape
    for name, x, shape in (("Ct", Ct, (T, n_b, k_b)),
                           ("St", St, (T, n_b, k_b)),
                           ("Gt", Gt, (T, n_b, k_b)),
                           ("init", init, (k_b, M)),
                           ("ATfresh", ATfresh, (T * n_b, M))):
        if x.device != dev or x.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32 on {dev}, got "
                            f"{x.dtype} on {x.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {shape}, got "
                             f"{tuple(x.shape)}")
    threads = clamp_m_blk(M, WAVE_M_BLK)
    smem = wave_smem_bytes(n_b, k_b, threads)
    if smem > SMEM_PER_BLOCK:
        raise ValueError(f"n_b={n_b}, k_b={k_b} need {smem} B of shared "
                         f"memory a block; a block has {SMEM_PER_BLOCK}")
    fn = _lib()
    out = torch.empty_like(ATfresh)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ATfresh.data_ptr(), Ct.data_ptr(), St.data_ptr(),
                Gt.data_ptr(), init.data_ptr(), out.data_ptr(), T, n_b, k_b,
                M, threads, stream)
    if rc != 0:
        raise RuntimeError(f"rotseq_wave launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return out
