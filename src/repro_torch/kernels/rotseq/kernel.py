"""Wrapper of the CUDA wavefront kernel (``csrc/rotseq_wave.cu``).

Counterpart of ``repro.kernels.rotseq.kernel.rotseq_wave_pallas``.  On a
CPU tensor it runs the plain version; on a CUDA tensor it launches the
kernel or raises, and never falls back.  ``LAUNCHES`` counts launches,
and with :mod:`repro_torch.obs` on each launch also bumps
``kernels.rotseq.launches`` at the same line.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import obs
from repro_torch.kernels import _build
from repro_torch.kernels.limits import WAVE_KB, WAVE_WARPS

from .ref import rotseq_wave_ref

__all__ = ["rotseq_wave", "traffic_bytes", "LAUNCHES"]

LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int


def traffic_bytes(n: int, M: int, K: int, itemsize: int = 4) -> int:
    """Bytes one launch moves through memory: the packed operand read
    and written once a pass (a pass runs ``WAVE_WARPS`` bands of
    ``WAVE_KB`` waves, so ``K <= 192`` is one pass) and the three ``(K,
    n-1)`` panels read once.  Not the reference's ``2·m·n·bands``: the
    Pallas kernel makes a trip through memory a band."""
    passes = math.ceil(math.ceil(K / WAVE_KB) / WAVE_WARPS)
    return (2 * n * M * passes + 3 * K * max(n - 1, 0)) * itemsize


def _lib():
    fn = _build.load().rotseq_wave_f32
    fn.argtypes = [_P] * 5 + [_I] * 3 + [_P]
    fn.restype = _I
    return fn


def rotseq_wave(AT, Cw, Sw, Gw, *, k_b: int = WAVE_KB, n_b=None):
    """Apply all waves of the panels to the packed operand.

    Args:
      AT: ``(n, m)`` packed target (``AT[i] = A[:, i]``).
      Cw, Sw, Gw: ``(K, n - 1)`` wave-major panels of cosines, sines and
        per-entry signs (``Cw[p, j] = C[j, p]``).
      k_b: waves a band.  The kernel is compiled for ``WAVE_KB`` only.
      n_b: tile width of the plain version (the CPU path; its result does
        not depend on it).  The kernel streams whole rows and has no
        tiles, so on a CUDA tensor it must be ``None``.

    On the card one launch applies every band: a block is a group of 32
    rows of ``A`` whose bands run on several warps at once, each a fixed
    lag behind the one before (``csrc/rotseq_wave.cu``).

    Returns ``(n, m)``: the packed result, ``A_final`` transposed.
    """
    global LAUNCHES
    dev = AT.device
    if dev.type == "cpu":
        return rotseq_wave_ref(AT, Cw, Sw, Gw, k_b=k_b, n_b=n_b)
    if dev.type != "cuda":
        raise ValueError(f"rotseq_wave runs on cuda or cpu, not {dev}")
    if k_b != WAVE_KB:
        raise ValueError(f"the wavefront kernel is compiled for k_b = "
                         f"{WAVE_KB}, not {k_b}")
    if n_b is not None:
        raise ValueError("the wavefront kernel has no column tiles: n_b "
                         "is for its plain version only")
    n, M = AT.shape
    K = Cw.shape[0]
    for name, x, shape in (("AT", AT, (n, M)), ("Cw", Cw, (K, n - 1)),
                           ("Sw", Sw, (K, n - 1)), ("Gw", Gw, (K, n - 1))):
        if x.device != dev or x.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32 on {dev}, got "
                            f"{x.dtype} on {x.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {shape}, got "
                             f"{tuple(x.shape)}")
    if K * max(n - 1, 0) >= 2 ** 31:
        raise ValueError(f"panels of {K} x {n - 1} exceed the kernel's "
                         f"32-bit offsets")
    out = torch.empty_like(AT)
    if K == 0 or n < 2:                 # no planes: nothing to launch
        return out.copy_(AT)
    fn = _lib()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(AT.data_ptr(), Cw.data_ptr(), Sw.data_ptr(), Gw.data_ptr(),
                out.data_ptr(), n, M, K, stream)
    if rc != 0:
        raise RuntimeError(f"rotseq_wave launch failed: CUDA error {rc}")
    LAUNCHES += 1
    obs.inc("kernels.rotseq.launches")
    return out
