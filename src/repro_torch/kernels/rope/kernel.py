"""Wrapper of the CUDA fused RoPE kernel (``csrc/rope.cu``).

Counterpart of ``repro.kernels.rope.kernel.rope_pallas`` mapped over the
batch.  On CPU tensors it runs the plain version; on CUDA tensors it
launches the kernel or raises, and never falls back.  ``LAUNCHES``
counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

from .ref import apply_rope_ref

__all__ = ["rope", "LAUNCHES"]

LAUNCHES = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_ENTRY = {torch.float32: "rope_f32", torch.bfloat16: "rope_bf16"}


def _lib(dtype):
    fn = getattr(_build.load(), _ENTRY[dtype])
    fn.argtypes = [_P] * 6 + [_I] * 5 + [_P]
    fn.restype = _I
    return fn


def rope(q, k, cos, sin):
    """Rotate q ``(B, S, Hq, D)`` and k ``(B, S, Hk, D)`` by tables
    ``(S, D/2)`` in one launch; returns new ``(q, k)``.

    On the card one thread owns pair ``i`` of position ``(b, s)`` and
    rotates it in every head of q and k, so the tables are read once.
    """
    global LAUNCHES
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k are (B, S, H, D); got {tuple(q.shape)} "
                         f"and {tuple(k.shape)}")
    B, S, Hq, D = q.shape
    if tuple(k.shape[:2]) != (B, S) or k.shape[3] != D or D % 2:
        raise ValueError(f"k {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)} (even head_dim)")
    for name, t in (("cos", cos), ("sin", sin)):
        if tuple(t.shape) != (S, D // 2):
            raise ValueError(f"{name}: expected {(S, D // 2)}, got "
                             f"{tuple(t.shape)}")
    dev = q.device
    if dev.type == "cpu":
        return apply_rope_ref(q, cos, sin), apply_rope_ref(k, cos, sin)
    if dev.type != "cuda":
        raise ValueError(f"rope runs on cuda or cpu, not {dev}")
    if q.dtype not in _ENTRY:
        raise TypeError(f"the kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    for name, t in (("k", k), ("cos", cos), ("sin", sin)):
        if t.device != dev or t.dtype != q.dtype:
            raise TypeError(f"{name}: the kernel takes {q.dtype} on {dev}, "
                            f"got {t.dtype} on {t.device}")
    for name, t in (("q", q), ("k", k), ("cos", cos), ("sin", sin)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes a contiguous tensor")
    fn = _lib(q.dtype)
    qo = torch.empty_like(q)
    ko = torch.empty_like(k)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), cos.data_ptr(), sin.data_ptr(),
                qo.data_ptr(), ko.data_ptr(), B, S, Hq, k.shape[2], D,
                stream)
    if rc != 0:
        raise RuntimeError(f"rope launch failed: CUDA error {rc}")
    LAUNCHES += 1
    return qo, ko
