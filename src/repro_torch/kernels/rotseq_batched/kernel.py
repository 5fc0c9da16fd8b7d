"""Wrapper of the CUDA fused batched kernel (``csrc/rotseq_batched.cu``).

Counterpart of ``repro.kernels.rotseq_batched.kernel.
rotseq_batched_pallas``.  On a CPU tensor it runs the plain version; on
a CUDA tensor it launches the kernel or raises, and never falls back.
``LAUNCHES`` counts launches, and with :mod:`repro_torch.obs` on each
launch also bumps ``kernels.rotseq_batched.launches`` at the same line
(``cuda_mxu``'s tile-factor launches too).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch import obs
from repro_torch.kernels import _build
from repro_torch.kernels.limits import BATCHED_KB, BATCHED_M_BLK

from .ref import rotseq_batched_ref, row_blocks

__all__ = ["rotseq_batched", "traffic_bytes", "LAUNCHES"]

LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int

# gridDim.y (row blocks of one request) is at most 65535
_MAX_ROW_BLOCKS = 65535
# the kernel indexes one request's panel with 32-bit ints
_MAX_PANEL = 2 ** 31


def traffic_bytes(b: int, bs: int, n: int, m: int, K: int,
                  itemsize: int = 4) -> int:
    """Bytes one launch moves through memory, counted at full width:
    each target ``(n, m)`` read and written once a band of
    ``BATCHED_KB`` waves (a band touches only its hulls' columns, so
    padded and staircase grids move less), the three ``(bs, K, n-1)``
    panels read once and the int32 windows ``(bs, K)`` read once."""
    bands = math.ceil(K / BATCHED_KB)
    return ((2 * b * n * m * bands + 3 * bs * K * max(n - 1, 0)) * itemsize
            + 2 * bs * K * 4)


def _lib():
    fn = _build.load().rotseq_batched_f32
    fn.argtypes = [_P] * 8 + [_I] * 6 + [_P]
    fn.restype = _I
    return fn


def rotseq_batched(AT, C, S, G, starts, counts):
    """Apply every request's waves to its packed target in one launch.

    Args:
      AT: ``(b, n, m)`` packed targets (``AT[i] = A_i^T``).
      C, S, G: ``(bs, K, n-1)`` wave-major panels (``C[r, p, j]`` is
        plane ``(j, p)`` of request ``r``), ``bs`` 1 for one shared
        sequence or ``b`` for one sequence per request; ``G`` the sign.
      starts, counts: ``(bs, K)`` int32 live window of every wave: wave
        ``p`` applies planes ``starts[p] .. starts[p] + counts[p] - 1``
        in order and skips the rest.

    On the card a block owns :data:`~repro_torch.kernels.limits.
    BATCHED_M_BLK` rows of one request, one thread a row, and walks the
    waves in bands, each band's window of columns in registers.

    Returns ``(out, planes)``: ``out`` ``(b, n, m)`` and ``planes``
    ``(b, R)`` int32, the planes each row block applied.
    """
    global LAUNCHES
    b, n, m = AT.shape
    bs, K, J = C.shape
    if J != n - 1 or bs not in (1, b):
        raise ValueError(f"panels {tuple(C.shape)} do not fit targets "
                         f"{tuple(AT.shape)}")
    for name, x, shape in (("S", S, C.shape), ("G", G, C.shape),
                           ("starts", starts, (bs, K)),
                           ("counts", counts, (bs, K))):
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: expected {tuple(shape)}, got "
                             f"{tuple(x.shape)}")
    R = row_blocks(m)
    dev = AT.device
    if dev.type == "cpu":
        return rotseq_batched_ref(AT, C, S, G, starts, counts)
    if dev.type != "cuda":
        raise ValueError(f"rotseq_batched runs on cuda or cpu, not {dev}")
    for name, x, dtype in (("AT", AT, torch.float32), ("C", C, torch.float32),
                           ("S", S, torch.float32), ("G", G, torch.float32),
                           ("starts", starts, torch.int32),
                           ("counts", counts, torch.int32)):
        if x.device != dev or x.dtype != dtype:
            raise TypeError(f"{name}: the kernel takes {dtype} on {dev}, "
                            f"got {x.dtype} on {x.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: the kernel takes a contiguous tensor")
    if R > _MAX_ROW_BLOCKS:
        raise ValueError(f"m={m} rows need {R} row blocks; a launch takes "
                         f"at most {_MAX_ROW_BLOCKS}")
    if K * J >= _MAX_PANEL:
        raise ValueError(f"a panel of {K} x {J} planes passes the kernel's "
                         f"32-bit plane index")
    fn = _lib()
    out = torch.empty_like(AT)
    planes = torch.empty((b, R), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(AT.data_ptr(), C.data_ptr(), S.data_ptr(), G.data_ptr(),
                starts.data_ptr(), counts.data_ptr(), out.data_ptr(),
                planes.data_ptr(), b, n, m, K, int(bs > 1),
                BATCHED_M_BLK, stream)
    if rc != 0:
        raise RuntimeError(f"rotseq_batched launch failed: CUDA error {rc}")
    LAUNCHES += 1
    obs.inc("kernels.rotseq_batched.launches")
    return out, planes
