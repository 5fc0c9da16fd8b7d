"""Wrapper of the CUDA fused RoPE kernel (``csrc/rope.cu``).

Counterpart of ``repro.kernels.rope.kernel.rope_pallas`` mapped over the
batch.  On CPU tensors it runs the plain version; on CUDA tensors it
launches the kernel or raises, and never falls back.  ``LAUNCHES``
counts launches, backward ones too, ``PATH_LAUNCHES`` the launches of
each of the kernel's two paths (:func:`vector_path` says which one a call
takes).

The rotation is differentiable in q and k (not in the tables).  Its
backward is the inverse rotation of ``(dq, dk)``: one launch of the same
kernel with ``inverse`` set, which reads ``sin`` negated, an exact sign
flip, so the gradient equals autograd of the plain version bit for bit;
on the CPU the plain version runs with ``-sin``.

On ``meta`` tensors (the dry run, ``repro_torch.launch.dryrun``) the
plain version's ops run on the meta tensors, computing only shapes, so a
step's count prices RoPE as the reference's dry run does; a launch
tells :func:`repro_torch.launch.step_analysis.opaque` the same ops, so a
step analyzed on the card counts them too.

The decode step calls this once a layer, so the host work of a call is
kept small: each ctypes entry is resolved and typed once a dtype, the
stream is read without switching devices when the tensor lies on the
current one, and the checks are plain comparisons.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.compat import cuda_current_device, cuda_raw_stream
from repro_torch.kernels import _build
from repro_torch.launch import step_analysis

from .ref import apply_rope_ref

__all__ = ["rope", "vector_path", "LAUNCHES", "PATH_LAUNCHES"]

LAUNCHES = 0
PATH_LAUNCHES = {"vector": 0, "scalar": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_ENTRY = {torch.float32: "rope_f32", torch.bfloat16: "rope_bf16"}
_FN = {}

# bytes a thread of the vector path loads of x1, of x2, of cos and of sin
VECTOR_BYTES = 16


def vector_path(head_dim: int, element_size: int, addresses) -> bool:
    """Whether the kernel takes its vector path: a head half is a whole
    number of 16-byte chunks and every address (q, k, cos, sin and the
    two outputs) is 16-byte aligned; else its scalar path.  The rule of
    ``rope.cu::vector_path``."""
    bits = 0
    for a in addresses:
        bits |= a
    return ((head_dim // 2) * element_size % VECTOR_BYTES == 0
            and bits % VECTOR_BYTES == 0)


def _entry(dtype):
    fn = _FN.get(dtype)
    if fn is None:
        fn = getattr(_build.load(), _ENTRY[dtype])
        fn.argtypes = [_P] * 6 + [_I] * 6 + [_P]
        fn.restype = _I
        _FN[dtype] = fn
    return fn


def _refuse_shapes(q, k, cos, sin):
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"q and k are (B, S, H, D); got {tuple(q.shape)} "
                         f"and {tuple(k.shape)}")
    B, S, _, D = q.shape
    if k.shape[0] != B or k.shape[1] != S or k.shape[3] != D or D % 2:
        raise ValueError(f"k {tuple(k.shape)} does not fit q "
                         f"{tuple(q.shape)} (even head_dim)")
    for name, t in (("cos", cos), ("sin", sin)):
        if t.shape != (S, D // 2):
            raise ValueError(f"{name}: expected {(S, D // 2)}, got "
                             f"{tuple(t.shape)}")


def _refuse_operands(q, k, cos, sin):
    """Raise for what the kernel does not take (called on a mismatch)."""
    if q.dtype not in _ENTRY:
        raise TypeError(f"the kernel takes float32 or bfloat16, got "
                        f"{q.dtype}")
    for name, t in (("k", k), ("cos", cos), ("sin", sin)):
        if t.device != q.device or t.dtype != q.dtype:
            raise TypeError(f"{name}: the kernel takes {q.dtype} on "
                            f"{q.device}, got {t.dtype} on {t.device}")
    for name, t in (("q", q), ("k", k), ("cos", cos), ("sin", sin)):
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes a contiguous tensor")


def rope(q, k, cos, sin):
    """Rotate q ``(B, S, Hq, D)`` and k ``(B, S, Hk, D)`` by tables
    ``(S, D/2)`` in one launch; returns new ``(q, k)``.

    On the card a thread rotates one 16-byte chunk of one head of q or k
    (the vector path), or one pair where the head half or an address is
    not 16-byte aligned (the scalar path).  Where q or k takes a gradient
    the call goes through :class:`_Rope`, whose backward is one launch
    more; else (serving, under ``inference_mode``) it launches directly.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad):
        return _Rope.apply(q, k, cos, sin)
    return _rotate(q, k, cos, sin, False)


class _Rope(torch.autograd.Function):
    """RoPE with the inverse rotation as its backward."""

    @staticmethod
    def forward(ctx, q, k, cos, sin):
        ctx.save_for_backward(cos, sin)
        return _rotate(q, k, cos, sin, False)

    @staticmethod
    def backward(ctx, dq, dk):
        cos, sin = ctx.saved_tensors  # an unused output's grad is zeros
        gq, gk = _rotate(dq.contiguous(), dk.contiguous(), cos, sin, True)
        return gq, gk, None, None


def _rotate(q, k, cos, sin, inverse: bool):
    """One launch of the kernel (``inverse``: rotate by ``-sin``), or its
    plain version for CPU tensors."""
    global LAUNCHES
    if q.dim() != 4 or k.dim() != 4 or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3] or q.shape[3] % 2 \
            or cos.shape != (q.shape[1], q.shape[3] // 2) \
            or sin.shape != cos.shape:
        _refuse_shapes(q, k, cos, sin)
    if not q.is_cuda:
        if q.device.type not in ("cpu", "meta"):
            raise ValueError(f"rope runs on cuda, cpu or meta, not "
                             f"{q.device}")
        return _plain(q, k, cos, sin, inverse)
    dtype, dev = q.dtype, q.get_device()
    if dtype not in _ENTRY or k.dtype != dtype or cos.dtype != dtype \
            or sin.dtype != dtype or k.get_device() != dev \
            or cos.get_device() != dev or sin.get_device() != dev \
            or not (q.is_contiguous() and k.is_contiguous()
                    and cos.is_contiguous() and sin.is_contiguous()):
        _refuse_operands(q, k, cos, sin)
    B, S, Hq, D = q.shape
    qo = torch.empty_like(q)
    ko = torch.empty_like(k)
    if qo.numel() + ko.numel() == 0:
        return qo, ko
    fn = _entry(dtype)
    ptrs = (q.data_ptr(), k.data_ptr(), cos.data_ptr(), sin.data_ptr(),
            qo.data_ptr(), ko.data_ptr())
    inv = 1 if inverse else 0
    if dev == cuda_current_device():
        rc = fn(*ptrs, B, S, Hq, k.shape[2], D, inv, cuda_raw_stream(dev))
    else:
        with torch.cuda.device(dev):
            rc = fn(*ptrs, B, S, Hq, k.shape[2], D, inv,
                    cuda_raw_stream(dev))
    if rc != 0:
        raise RuntimeError(f"rope launch failed: CUDA error {rc}")
    step_analysis.opaque(_plain, q, k, cos, sin, inverse)
    LAUNCHES += 1
    PATH_LAUNCHES["vector" if vector_path(D, q.element_size(), ptrs)
                  else "scalar"] += 1
    return qo, ko


def _plain(q, k, cos, sin, inverse: bool):
    """The plain version (``inverse``: by ``-sin``): what a CPU tensor
    runs, and, on ``meta`` tensors, the shapes alone."""
    if inverse:
        sin = -sin
    # reached off the card only: _rotate calls it under `not q.is_cuda`,
    # and step_analysis.opaque replays it on meta copies of a launch's
    # operands to count the launch's ops
    # repro-torch-lint: disable-next=RA105
    return apply_rope_ref(q, cos, sin), apply_rope_ref(k, cos, sin)
