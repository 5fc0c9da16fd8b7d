"""Wrapper of the CUDA wavefront kernel (``csrc/rotseq_wave.cu``).

Counterpart of ``repro.kernels.rotseq.kernel.rotseq_wave_pallas``.  On a
CPU tensor it runs the plain version; on a CUDA tensor it launches the
kernel or raises, and never falls back.  ``LAUNCHES`` counts launches,
``DTYPE_LAUNCHES`` the same launches by the operand's dtype,
``BAND_LAUNCHES`` by the band they ran at, and with
:mod:`repro_torch.obs` on each launch also bumps
``kernels.rotseq.launches`` at the same line.  The kernel takes float32,
bfloat16 and float16, one entry of the library each, as the reference's
Pallas kernel takes the operand's dtype; float64 has no entry.  It is
compiled for the bands ``WAVE_BANDS`` (the reference's kernel takes any
``k_b``): 16 waves, and 4 for few waves.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import obs
from repro_torch.kernels import _build
from repro_torch.kernels.limits import (WAVE_BANDS, WAVE_KB, WAVE_SMALL_BANDS,
                                        WAVE_SMALL_KB, WAVE_WARPS)

from .ref import rotseq_wave_ref

__all__ = ["rotseq_wave", "traffic_bytes", "passes", "check_band",
           "LAUNCHES", "DTYPE_LAUNCHES", "BAND_LAUNCHES", "ENTRY"]

LAUNCHES = 0
DTYPE_LAUNCHES = {"float32": 0, "bfloat16": 0, "float16": 0}
BAND_LAUNCHES = {kb: 0 for kb in WAVE_BANDS}

_P = ctypes.c_void_p
_I = ctypes.c_int
# the library's entry of each operand dtype (csrc/rotseq_wave.cu)
ENTRY = {torch.float32: "rotseq_wave_f32", torch.bfloat16: "rotseq_wave_bf16",
         torch.float16: "rotseq_wave_f16"}
_FN = {}


def passes(K: int, k_b: int = WAVE_KB) -> int:
    """Passes of one launch through the packed operand: each runs
    ``WAVE_WARPS`` bands of ``k_b`` waves, one a warp of a row group
    (``K <= 192`` is one pass at ``k_b = 16``), or at the small band
    ``WAVE_SMALL_BANDS`` bands, one a lane of a warp's row (``K <= 32``
    at 4)."""
    per_pass = WAVE_SMALL_BANDS if k_b == WAVE_SMALL_KB else WAVE_WARPS
    return math.ceil(math.ceil(K / k_b) / per_pass)


def traffic_bytes(n: int, M: int, K: int, itemsize: int = 4,
                  k_b: int = WAVE_KB) -> int:
    """Bytes one launch at bands of ``k_b`` waves moves through memory:
    the packed operand read and written once a pass (:func:`passes`) and
    the three ``(K, n-1)`` panels read once.  Not the reference's
    ``2·m·n·bands``: the Pallas kernel makes a trip through memory a
    band."""
    return (2 * n * M * passes(K, k_b) + 3 * K * max(n - 1, 0)) * itemsize


def check_band(k_b: int, n_b=None) -> None:
    """Raise ``ValueError`` unless the kernel is compiled for bands of
    ``k_b`` waves and ``n_b`` is ``None`` (it streams whole rows and has
    no column tiles)."""
    if k_b not in WAVE_BANDS:
        raise ValueError(f"the wavefront kernel is compiled for k_b in "
                         f"{WAVE_BANDS}, not {k_b}")
    if n_b is not None:
        raise ValueError("the wavefront kernel has no column tiles: n_b "
                         "is for its plain version only")


def _entry(dtype):
    """The library's entry for operands of ``dtype``; raises ``TypeError``
    for a dtype the kernel has no entry for."""
    if dtype not in ENTRY:
        raise TypeError(f"the wavefront kernel takes "
                        f"{', '.join(map(str, ENTRY))}, not {dtype}")
    fn = _FN.get(dtype)
    if fn is None:
        fn = getattr(_build.load(), ENTRY[dtype])
        fn.argtypes = [_P] * 5 + [_I] * 4 + [_P]
        fn.restype = _I
        _FN[dtype] = fn
    return fn


def rotseq_wave(AT, Cw, Sw, Gw, *, k_b: int = WAVE_KB, n_b=None):
    """Apply all waves of the panels to the packed operand.

    Args:
      AT: ``(n, m)`` packed target (``AT[i] = A[:, i]``), float32,
        bfloat16 or float16 on the card.
      Cw, Sw, Gw: ``(K, n - 1)`` wave-major panels of cosines, sines and
        per-entry signs (``Cw[p, j] = C[j, p]``), in ``AT``'s dtype.
      k_b: waves a band.  The kernel is compiled for ``WAVE_BANDS``
        only (:func:`check_band`).  On finite nonzero values its result
        does not depend on it; the sign of a zero and where inf or NaN
        spread can, through the pad planes of the last band.
      n_b: tile width of the plain version (the CPU path; its result does
        not depend on it).  The kernel streams whole rows and has no
        tiles, so on a CUDA tensor it must be ``None``.

    On the card one launch applies every band: a block is a group of 32
    rows of ``A`` whose bands run on several warps at once, each a fixed
    lag behind the one before; at the small band a warp is 4 rows by 8
    bands, one (row, band) pair a lane, each band a window behind the one
    before, its columns handed on by shuffles (``csrc/rotseq_wave.cu``).

    Returns ``(n, m)``: the packed result, ``A_final`` transposed.
    """
    global LAUNCHES
    dev = AT.device
    if dev.type == "cpu":
        return rotseq_wave_ref(AT, Cw, Sw, Gw, k_b=k_b, n_b=n_b)
    if dev.type != "cuda":
        raise ValueError(f"rotseq_wave runs on cuda or cpu, not {dev}")
    check_band(k_b, n_b)
    n, M = AT.shape
    K = Cw.shape[0]
    for name, x, shape in (("AT", AT, (n, M)), ("Cw", Cw, (K, n - 1)),
                           ("Sw", Sw, (K, n - 1)), ("Gw", Gw, (K, n - 1))):
        if x.device != dev or x.dtype != AT.dtype:
            raise TypeError(f"{name}: the kernel takes {AT.dtype} on {dev}, "
                            f"got {x.dtype} on {x.device}")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {shape}, got "
                             f"{tuple(x.shape)}")
    if K * max(n - 1, 0) >= 2 ** 31:
        raise ValueError(f"panels of {K} x {n - 1} exceed the kernel's "
                         f"32-bit offsets")
    fn = _entry(AT.dtype)
    out = torch.empty_like(AT)
    if K == 0 or n < 2:                 # no planes: nothing to launch
        return out.copy_(AT)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(AT.data_ptr(), Cw.data_ptr(), Sw.data_ptr(), Gw.data_ptr(),
                out.data_ptr(), n, M, K, k_b, stream)
    if rc != 0:
        raise RuntimeError(f"rotseq_wave launch failed: CUDA error {rc}")
    LAUNCHES += 1
    DTYPE_LAUNCHES[str(AT.dtype).replace("torch.", "")] += 1
    BAND_LAUNCHES[k_b] += 1
    obs.inc("kernels.rotseq.launches")
    return out
