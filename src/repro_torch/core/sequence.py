"""First-class rotation sequences: plan once, apply many.

Mirror of :mod:`repro.core.sequence` in PyTorch.

* :class:`RotationSequence` holds ``cos``/``sin`` waves of shape
  ``(n-1, k)``, an optional per-entry ``sign`` (``-1`` rotation, ``+1``
  reflector) and a ``reflect`` flag.  ``seq.T`` is the exact inverse,
  ``seq1 @ seq2`` concatenates waves, ``seq[i:j]`` slices them and
  :meth:`~RotationSequence.pad_to` identity-pads.
* ``plan = seq.plan(like=A)`` resolves the backend registry once
  (capability filter, SS6 cost model, plan cache) for the device of
  ``A``; ``plan.apply(A)`` then calls the chosen backend directly.
* ``plan.apply`` is a :class:`torch.autograd.Function`: application is
  linear in ``A``, so its backward is one application of ``seq.T``
  through the same planned backend.  The sequence is a constant.

Tensors stay on the device they are given.  Constructors that build
tensors from scratch (or from numpy) take ``device=``, by default the
card, and raise when there is none.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import registry

__all__ = ["RotationSequence", "SequencePlan", "resolve_device"]

_ROT = -1.0      # plain rotation (identity padding is a no-op)
_REFL = 1.0      # 2x2 reflector (paper SS8.4)

# relative drift of c^2 + s^2 (in ulps of the wave dtype) above which
# from_waves(normalize="auto") renormalizes an entry
_DRIFT_ULPS = 64

# sentinel backend name for degenerate (zero-rotation) plans
_IDENTITY = "identity"


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device when there is none."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to build "
            "tensors on the host")
    return device


def _as_tensor(x, device):
    """Tensors stay where they are unless ``device`` is given; anything
    else is converted onto ``device`` (the card by default)."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(resolve_device(device))
    return torch.as_tensor(np.asarray(x),
                           device=resolve_device(device or "cuda"))


def _dtype_name(dtype) -> str:
    return str(dtype).replace("torch.", "")


def _ensure_backends() -> None:
    """Planning needs the backend registry populated (api.py does it)."""
    import repro_torch.core.api  # noqa: F401  (import side effect)


@dataclasses.dataclass(frozen=True, eq=False)
class RotationSequence:
    """A sequence of ``(n-1) * k`` planar rotations in the paper's layout.

    ``cos``/``sin`` have shape ``(n-1, k)``: entry ``(j, p)`` acts on
    columns ``(j, j+1)`` during wave ``p``.  ``k_live`` is an optional
    upper bound on the non-identity planes (``None`` = assume dense),
    kept by ``pad_to``, ``.T`` and ``identity``.
    """

    cos: Any
    sin: Any
    sign: Any = None
    reflect: bool = False
    k_live: Optional[int] = None

    @property
    def n(self) -> int:
        """Width of a compatible target matrix (``planes + 1``)."""
        return self.cos.shape[0] + 1

    @property
    def k(self) -> int:
        """Number of waves."""
        return self.cos.shape[1]

    @property
    def shape(self) -> Tuple[int, int]:
        return tuple(self.cos.shape)

    @property
    def dtype(self):
        return self.cos.dtype

    @property
    def device(self) -> torch.device:
        return self.cos.device

    def __repr__(self) -> str:
        return (f"RotationSequence(n={self.n}, k={self.k}, "
                f"dtype={self.dtype}, device={self.device}, "
                f"sign={'per-entry' if self.sign is not None else None}, "
                f"reflect={self.reflect})")

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_waves(cls, cos, sin, sign=None, *, reflect: bool = False,
                   normalize: str | bool = "auto",
                   device=None) -> "RotationSequence":
        """Build from ``(n-1, k)`` wave arrays, validating the layout.

        Tensors stay on their device unless ``device`` is given; numpy
        arrays and lists go to ``device``, the card by default.
        ``normalize``: ``"auto"`` renormalizes only entries whose
        ``c^2 + s^2`` drifts from 1 by more than ~64 ulp (exact pairs
        pass through bit for bit); ``True`` always divides by
        ``hypot(c, s)``; ``False`` stores the arrays untouched.
        """
        cos = _as_tensor(cos, device)
        sin = _as_tensor(sin, cos.device)
        if cos.ndim != 2:
            raise ValueError(f"waves must be 2D (n-1, k), got "
                             f"{tuple(cos.shape)}")
        if cos.shape != sin.shape:
            raise ValueError(f"cos/sin shape mismatch: {tuple(cos.shape)} "
                             f"vs {tuple(sin.shape)}")
        if sign is not None:
            sign = _as_tensor(sign, cos.device)
            if sign.shape != cos.shape:
                raise ValueError(f"sign shape {tuple(sign.shape)} != wave "
                                 f"shape {tuple(cos.shape)}")
        one = torch.ones((), dtype=cos.dtype, device=cos.device)
        if normalize == "auto":
            r2 = cos * cos + sin * sin
            finfo = torch.finfo(r2.dtype if r2.is_floating_point()
                                else torch.float32)
            drift = (r2 - 1.0).abs() > _DRIFT_ULPS * finfo.eps
            pos = r2 > 0
            r = torch.sqrt(torch.where(pos, r2, one))
            # a (0, 0) pair has no direction: repair it to the identity
            cos = torch.where(drift, torch.where(pos, cos / r, one), cos)
            sin = torch.where(drift, torch.where(pos, sin / r, 0 * one), sin)
        elif normalize:
            r = torch.hypot(cos, sin)
            safe = r > 0
            rs = torch.where(safe, r, one)
            cos = torch.where(safe, cos / rs, one)
            sin = torch.where(safe, sin / rs, 0 * one)
        return cls(cos, sin, sign, reflect)

    @classmethod
    def identity(cls, n: int, k: int, *, dtype=torch.float32,
                 device="cuda") -> "RotationSequence":
        """``k`` identity waves on ``n`` columns (exact no-op)."""
        device = resolve_device(device)
        return cls(torch.ones((n - 1, k), dtype=dtype, device=device),
                   torch.zeros((n - 1, k), dtype=dtype, device=device),
                   k_live=0)

    # -- composition -------------------------------------------------------
    @property
    def T(self) -> "RotationSequence":
        """The inverse sequence: ``seq.T`` undoes ``seq`` exactly.

        Each plane's transpose ``M(c, s, g)^T = M(c, g s, g)`` stays on
        its column pair; applied in reversed order they re-pack into an
        ``(n-1, n+k-2)`` anti-diagonal staircase: the plane from
        ``(j, p)`` lands in wave ``(n-2-j) + (k-1-p)``.
        """
        c_t, s_t, g_t, refl_t = _transpose_waves(
            self.cos, self.sin, self.sign, self.reflect)
        J, k = self.cos.shape
        live = self.k_live if self.k_live is not None else J * k
        return RotationSequence(c_t, s_t, g_t, refl_t, k_live=live)

    def __matmul__(self, other: "RotationSequence") -> "RotationSequence":
        """Concatenate along ``K``: ``seq1 @ seq2`` applies ``seq1`` then
        ``seq2``."""
        if not isinstance(other, RotationSequence):
            return NotImplemented
        if self.cos.shape[0] != other.cos.shape[0]:
            raise ValueError(
                f"cannot compose sequences on {self.n} and {other.n} columns")
        cos = torch.cat([self.cos, other.cos], dim=1)
        sin = torch.cat([self.sin, other.sin], dim=1)
        live = None
        if self.k_live is not None and other.k_live is not None:
            live = self.k_live + other.k_live
        if (self.sign is None and other.sign is None
                and self.reflect == other.reflect):
            return RotationSequence(cos, sin, None, self.reflect,
                                    k_live=live)
        sign = torch.cat([self._sign_array(), other._sign_array()], dim=1)
        return RotationSequence(cos, sin, sign, False, k_live=live)

    def __getitem__(self, idx) -> "RotationSequence":
        """Wave slicing: ``seq[i:j]`` keeps waves ``i..j-1``."""
        if not isinstance(idx, slice):
            raise TypeError(
                "RotationSequence supports wave *slices* only (seq[i:j]); "
                "a single wave is seq[p:p+1]")
        return RotationSequence(
            self.cos[:, idx], self.sin[:, idx],
            None if self.sign is None else self.sign[:, idx], self.reflect)

    def pad_to(self, k_target: int) -> "RotationSequence":
        """Identity-pad to ``k_target`` waves.

        Padding waves are exact no-op *rotations*; an all-reflector
        sequence therefore materializes its ``sign`` array.  The
        pre-padding live-plane bound is kept.
        """
        pad = k_target - self.k
        if pad < 0:
            raise ValueError(f"cannot pad {self.k} waves down to {k_target}")
        if pad == 0:
            return self
        planes = self.cos.shape[0]
        live = self.k_live if self.k_live is not None else planes * self.k
        cos = torch.cat([self.cos, self.cos.new_ones((planes, pad))], dim=1)
        sin = torch.cat([self.sin, self.sin.new_zeros((planes, pad))], dim=1)
        if self.sign is None and not self.reflect:
            return RotationSequence(cos, sin, None, False, k_live=live)
        sign = torch.cat([self._sign_array(),
                          self.cos.new_full((planes, pad), _ROT)], dim=1)
        return RotationSequence(cos, sin, sign, False, k_live=live)

    def _sign_array(self):
        """Per-entry sign array (``reflect`` folded in), built on demand."""
        if self.sign is not None:
            return self.sign
        return torch.full_like(self.cos, _REFL if self.reflect else _ROT)

    def with_signs(self) -> "RotationSequence":
        """Per-entry-sign normal form: ``sign`` materialized, ``reflect``
        folded in."""
        if self.sign is not None:
            return self
        return RotationSequence(self.cos, self.sin, self._sign_array(),
                                False, k_live=self.k_live)

    # -- execution ---------------------------------------------------------
    def plan(self, like=None, *, m: Optional[int] = None,
             method: str = "auto", n_b: Optional[int] = None,
             k_b: Optional[int] = None, **kw) -> "SequencePlan":
        """Resolve the registry once into a frozen :class:`SequencePlan`.

        ``like`` (a tensor) supplies the row count, dtype and device of
        the target; ``m`` overrides the row count.  Without ``like`` the
        sequence's own dtype and device stand in.  ``method="auto"``
        runs the capability filter and cost model through the plan
        cache; a named method keeps the seed tiles (``n_b=64, k_b=16``
        for tiled backends).  Explicit ``n_b``/``k_b`` override both.
        """
        _ensure_backends()
        like_shape = getattr(like, "shape", None)
        if m is None:
            m = like_shape[0] if like_shape is not None else max(self.n, 1)
        dtype = _dtype_name(getattr(like, "dtype", None) or self.dtype)
        device = getattr(like, "device", None) or self.device
        n, k = self.n, self.k
        if method != "auto":
            spec = registry.get_backend(method)  # raises on unknown
            if self.sign is not None and not spec.capability.supports_signs:
                raise ValueError(
                    f"method {method!r} does not support per-entry signs; "
                    f"use a blocked-family backend")
        if n < 2 or k < 1 or m < 1:
            return SequencePlan(self, _IDENTITY, (), None)

        if method == "auto":
            plan = registry.select_plan(
                m, n, k, dtype=dtype, platform=torch.device(device).type,
                signs=self.sign is not None)
            planned = plan.kwargs()
            if n_b is not None:
                planned["n_b"] = n_b
            if k_b is not None:
                planned["k_b"] = k_b
            planned.update(kw)
            return SequencePlan(self, plan.method,
                                tuple(sorted(planned.items())), plan)

        planned = dict(kw)
        if spec.candidates is not registry.no_tiles:  # tiled backend
            planned["n_b"] = 64 if n_b is None else n_b
            planned["k_b"] = 16 if k_b is None else k_b
        return SequencePlan(self, method, tuple(sorted(planned.items())),
                            None)

    def apply(self, A, *, method: str = "auto", **kw):
        """One-shot convenience: ``seq.plan(like=A, ...).apply(A)``."""
        return self.plan(like=A, method=method, **kw).apply(A)


@dataclasses.dataclass(frozen=True, eq=False)
class SequencePlan:
    """A frozen dispatch decision bound to one :class:`RotationSequence`.

    ``apply(A)`` calls the resolved backend directly and is
    differentiable w.r.t. ``A`` (the backward applies ``seq.T``).
    :meth:`rebind` binds the same decision to new waves of the same
    shape.
    """

    sequence: RotationSequence
    method: str
    kwargs: Tuple[Tuple[str, Any], ...]
    plan: Optional[registry.Plan] = None

    def __repr__(self) -> str:
        return (f"SequencePlan(method={self.method!r}, "
                f"kwargs={dict(self.kwargs)}, seq={self.sequence!r})")

    def apply(self, A):
        """Apply the planned sequence: ``A <- A @ Q``.

        Differentiable w.r.t. ``A`` through every backend, kernels
        included: the gradient is one application of ``seq.T`` (an
        ``n + k - 2``-wave staircase, so a backward costs about
        ``(n + k) / k`` forwards).  The waves get no gradient.
        """
        self._check_target(A)
        if self.method == _IDENTITY:
            return A
        seq = self.sequence
        return _PlannedApply.apply(A, self.method, self.kwargs, seq.reflect,
                                   seq.cos, seq.sin, seq.sign)

    __call__ = apply

    def apply_direct(self, A):
        """Apply via the backend with PyTorch's own autograd (no custom
        backward): gradients reach the waves through the plain backends;
        a kernel's output carries no gradient."""
        self._check_target(A)
        if self.method == _IDENTITY:
            return A
        seq = self.sequence
        return _run_backend(self.method, self.kwargs, seq.reflect, A,
                            seq.cos, seq.sin, seq.sign)

    def _check_target(self, A):
        if self.method == _IDENTITY:
            return
        if A.ndim != 2 or A.shape[1] != self.sequence.n:
            raise ValueError(
                f"plan built for n={self.sequence.n} targets; "
                f"got A.shape={tuple(A.shape)}")

    def rebind(self, sequence: RotationSequence) -> "SequencePlan":
        """Bind this (method, tiles) decision to a new same-shape sequence."""
        old = self.sequence
        if sequence.shape != old.shape:
            raise ValueError(
                f"rebind needs matching wave shape {old.shape}; "
                f"got {sequence.shape}")
        if sequence.sign is not None and old.sign is None \
                and self.method != _IDENTITY:
            spec = registry.get_backend(self.method)
            if not spec.capability.supports_signs:
                raise ValueError(
                    f"plan method {self.method!r} cannot carry per-entry "
                    f"signs; re-plan the sign-carrying sequence")
        return dataclasses.replace(self, sequence=sequence)


# --------------------------------------------------------------------------
# planned application with a transposed-sequence backward
# --------------------------------------------------------------------------

def _transpose_waves(cos, sin, sign, reflect: bool):
    """Anti-diagonal staircase repack of one ``(n-1, k)`` wave grid.

    Returns ``(c_t, s_t, g_t, reflect_t)``; ``g_t`` is ``None`` for
    plain rotations and a sign grid otherwise (identity padding off the
    staircase must stay a rotation no-op).
    """
    J, k = cos.shape
    if sign is None:
        s_signed = sin if reflect else -sin
    else:
        s_signed = torch.where(sign > 0, sin, -sin)
    dev = cos.device
    j = torch.arange(J, device=dev)[:, None]
    q = torch.arange(J + k - 1, device=dev)[None, :]
    p_idx = (J - 1 - j) + (k - 1) - q
    valid = (p_idx >= 0) & (p_idx < k)
    pc = p_idx.clamp(0, max(k - 1, 0))
    jb = j.expand_as(pc)
    one = torch.ones((), dtype=cos.dtype, device=dev)
    if k == 0:
        c_t = one.expand(J, max(J - 1, 0)).clone()
        s_t = torch.zeros_like(c_t)
        g_src = None
    else:
        c_t = torch.where(valid, cos[jb, pc], one)
        s_t = torch.where(valid, s_signed[jb, pc], 0 * one)
        g_src = sign[jb, pc] if sign is not None else None
    g_t = None
    if sign is not None:
        g_t = (torch.where(valid, g_src, _ROT * one) if g_src is not None
               else torch.full_like(c_t, _ROT))
    elif reflect:
        g_t = torch.where(valid, _REFL * one, _ROT * one)
    return c_t, s_t, g_t, (False if g_t is not None else reflect)


def _run_backend(method: str, kwargs: Tuple[Tuple[str, Any], ...],
                 reflect: bool, A, C, S, G):
    spec = registry.get_backend(method)
    return spec.fn(A, C, S, reflect=reflect, G=G, **dict(kwargs))


class _PlannedApply(torch.autograd.Function):
    """``A @ Q`` through a planned backend; backward is ``dY @ Q^T``."""

    @staticmethod
    def forward(ctx, A, method, kwargs, reflect, C, S, G):
        ctx.method, ctx.kwargs, ctx.reflect = method, kwargs, reflect
        ctx.save_for_backward(C, S, G)
        return _run_backend(method, kwargs, reflect, A, C, S, G)

    @staticmethod
    def backward(ctx, dY):
        C, S, G = ctx.saved_tensors
        seq_t = RotationSequence(C, S, G, ctx.reflect).T
        method, kwargs = ctx.method, ctx.kwargs
        if seq_t.sign is not None and \
                not registry.get_backend(method).capability.supports_signs:
            # transposing an all-reflector sequence materializes a mixed
            # sign grid; route the cotangent through the blocked family
            method, kwargs = "blocked", tuple(
                (key, val) for key, val in kwargs if key in ("n_b", "k_b"))
        dA = _run_backend(method, kwargs, seq_t.reflect, dY.contiguous(),
                          seq_t.cos, seq_t.sin, seq_t.sign)
        return dA, None, None, None, None, None, None
