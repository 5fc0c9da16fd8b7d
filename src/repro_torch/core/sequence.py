"""First-class rotation sequences: plan once, apply many.

Mirror of :mod:`repro.core.sequence` in PyTorch.

* :class:`RotationSequence` holds ``cos``/``sin`` waves of shape
  ``(n-1, k)``, an optional per-entry ``sign`` (``-1`` rotation, ``+1``
  reflector) and a ``reflect`` flag.  ``seq.T`` is the exact inverse,
  ``seq1 @ seq2`` concatenates waves, ``seq[i:j]`` slices them and
  :meth:`~RotationSequence.pad_to` identity-pads.
* ``plan = seq.plan(like=A)`` resolves the backend registry once
  (capability filter, SS6 cost model or measured autotune, plan cache)
  for the device of ``A``; ``plan.apply(A)`` then calls the chosen
  backend directly.
* ``plan.apply`` is a :class:`torch.autograd.Function`: application is
  linear in ``A``, so its backward is one application of ``seq.T``
  through the same planned backend.  The sequence is a constant.
* ``plan.apply_batched(A, sequences=...)`` applies one sequence per
  target of a ``(b, m, n)`` batch (the serving path): in one launch on
  a ``batch_via="fused"`` backend (``cuda_batched``), flattened, mapped
  or looped otherwise, with the same transposed-sequence backward.
* ``to_dict``/``from_dict`` serialise sequences and plan decisions (the
  serve-plan store); a plan dict is keyed by the torch/CUDA build.
* With :mod:`repro_torch.obs` on, ``plan`` opens a ``plan`` span and
  every ``apply``/``apply_direct``/``apply_batched`` an ``apply`` or
  ``apply_batched`` span, counts ``sequence.applies``, observes
  ``sequence.apply_seconds`` and appends a roofline record; the seconds
  lie between two synchronizes of the target's device.  Under
  ``torch.autograd.grad`` the forward records one dispatch and the
  backward none; a tensor wrapped by ``torch.func`` records nothing.

Tensors stay on the device they are given.  Constructors that build
tensors from scratch (or from numpy) take ``device=``, by default the
card, and raise when there is none.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import registry

__all__ = ["RotationSequence", "SequencePlan", "resolve_device",
           "planned_apply", "planned_apply_batched", "planned_run",
           "stack_request_waves"]

_ROT = -1.0      # plain rotation (identity padding is a no-op)
_REFL = 1.0      # 2x2 reflector (paper SS8.4)

# relative drift of c^2 + s^2 (in ulps of the wave dtype) above which
# from_waves(normalize="auto") renormalizes an entry
_DRIFT_ULPS = 64

# sentinel backend name for degenerate (zero-rotation) plans
_IDENTITY = "identity"

# JSON format version of SequencePlan.to_dict (bump on layout change)
PLAN_DICT_FORMAT = 1

_NP_DTYPES = {"float32": np.float32, "float64": np.float64}


def _hypot(x, y):
    """``hypot(x, y)`` as ``jnp.hypot`` computes it, bit for bit in float32.

    ``jnp.hypot`` takes ``max * sqrt(1 + (min / max)^2)``, and XLA on the
    CPU contracts ``1 + r^2`` into one fused multiply-add, which
    ``torch.hypot`` (another algorithm) and the same formula in plain
    float32 round differently.  Here ``r^2 + 1`` is summed in float64
    (``r^2`` is exact there) and rounded once to float32, and the square
    root is taken in float64 and rounded to float32 (correctly rounded,
    as a float32 root is).  Zeros and infinities follow ``jnp.hypot``.
    Other dtypes keep ``torch.hypot``.
    """
    if x.dtype != torch.float32:
        return torch.hypot(x, y)
    ax, ay = x.abs(), y.abs()
    hi, lo = torch.maximum(ax, ay), torch.minimum(ax, ay)
    zero = hi == 0
    r = lo / torch.where(zero, torch.ones_like(hi), hi)
    r64 = r.double()
    t = (r64 * r64 + 1.0).float()
    h = hi * torch.sqrt(t.double()).float()
    h = torch.where(zero, hi, h)
    return torch.where(torch.isposinf(ax) | torch.isposinf(ay),
                       torch.full_like(h, float("inf")), h)


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


_dtype_name = registry.dtype_name


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
            r = _hypot(cos, sin)
            safe = r > 0
            rs = torch.where(safe, r, one)
            cos = torch.where(safe, cos / rs, one)
            sin = torch.where(safe, sin / rs, 0 * one)
        return cls(cos, sin, sign, reflect)

    @classmethod
    def from_pairs(cls, waves, *, reflect: bool = False,
                   device=None) -> "RotationSequence":
        """Build from an iterable of per-wave columns.

        Each element is ``(c, s)`` or ``(c, s, g)`` with 1D columns of a
        common length ``n-1``; waves are stacked along ``K`` in order.
        A ``None`` ``g`` is an all-rotation wave; if any wave carries
        signs, the missing ones are filled with rotations (reflectors
        under ``reflect=True``).  Columns are placed as ``from_waves``
        places them (``device``, the card by default for numpy).
        """
        waves = list(waves)
        if not waves:
            raise ValueError("from_pairs needs at least one wave; use "
                             "RotationSequence.identity for an empty one")
        cs, ss, gs = [], [], []
        for w in waves:
            c, s, g = (*w, None) if len(w) == 2 else w
            # the first wave fixes the device of the rest
            c = _as_tensor(c, cs[0].device if cs else device).reshape(-1)
            cs.append(c)
            ss.append(_as_tensor(s, c.device).reshape(-1))
            gs.append(None if g is None
                      else _as_tensor(g, c.device).reshape(-1))
        planes = cs[0].shape[0]
        for c, s in zip(cs, ss):
            if c.shape[0] != planes or s.shape[0] != planes:
                raise ValueError(
                    f"inconsistent wave lengths: {c.shape[0]} vs {planes}")
        sign = None
        if any(g is not None for g in gs):
            fill = cs[0].new_full((planes,), _REFL if reflect else _ROT)
            sign = torch.stack([fill if g is None else g for g in gs], dim=1)
        return cls.from_waves(torch.stack(cs, dim=1), torch.stack(ss, dim=1),
                              sign, reflect=reflect, normalize=False)

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

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        """JSON-serialisable dict (waves as nested lists), the layout of
        the reference's ``RotationSequence.to_dict``."""
        def lst(x):
            return x.detach().cpu().numpy().tolist()

        return {"cos": lst(self.cos), "sin": lst(self.sin),
                "sign": None if self.sign is None else lst(self.sign),
                "reflect": bool(self.reflect),
                "dtype": _dtype_name(self.dtype), "k_live": self.k_live}

    @classmethod
    def from_dict(cls, d: dict, *, device="cuda") -> "RotationSequence":
        """Inverse of :meth:`to_dict`, also for the reference's dicts.

        The waves are stored untouched (no renormalisation) on
        ``device``.  ``dtype`` is ``"float32"`` or ``"float64"``; by
        default the dtype of ``cos`` when it is a numpy array, else
        float32.
        """
        default = getattr(d["cos"], "dtype", np.dtype(np.float32))
        name = str(d.get("dtype") or default)
        if name not in _NP_DTYPES:
            raise ValueError(f"unsupported wave dtype {name!r}; one of "
                             f"{sorted(_NP_DTYPES)}")
        device = resolve_device(device)

        def conv(x):
            return torch.from_numpy(
                np.array(x, dtype=_NP_DTYPES[name], copy=True)).to(device)

        sign = d.get("sign")
        k_live = d.get("k_live")
        return cls(conv(d["cos"]), conv(d["sin"]),
                   None if sign is None else conv(sign),
                   bool(d.get("reflect", False)),
                   None if k_live is None else int(k_live))

    # -- execution ---------------------------------------------------------
    def plan(self, like=None, *, m: Optional[int] = None,
             method: str = "auto", autotune: bool = False,
             batch: Optional[int] = None, shared_sequence: bool = True,
             n_b: Optional[int] = None, k_b: Optional[int] = None,
             **kw) -> "SequencePlan":
        """Resolve the registry once into a frozen :class:`SequencePlan`.

        ``like`` (a tensor) supplies the row count, dtype and device of
        the target; ``m`` overrides the row count.  A 3D ``like``
        (``(b, m, n)``, a batch for :meth:`SequencePlan.apply_batched`)
        supplies the batch count too; ``batch`` overrides it.
        ``shared_sequence=False`` declares the batch per-request (each
        target brings its own sequence), which prices per-sequence setup
        ``b`` times.  The sequence's ``k_live`` reaches the cost model as
        its live planes.  Without ``like`` the sequence's own dtype and
        device stand in.  ``method="auto"`` runs the capability filter
        and cost model through the plan cache, or with ``autotune=True``
        measures the candidates on the target's device
        (:func:`~repro_torch.core.registry.select_plan`); a named method
        keeps the seed tiles (``n_b=64, k_b=16``, those a tiled backend
        takes).  Explicit ``n_b``/``k_b`` override both.  Other keywords
        reach the backend.
        """
        _ensure_backends()
        like_shape = getattr(like, "shape", None)
        if like_shape is not None and len(like_shape) == 3:
            if batch is None:
                batch = like_shape[0]
            if m is None:
                m = like_shape[1]
        if m is None:
            m = like_shape[0] if like_shape is not None else max(self.n, 1)
        batch = 1 if batch is None else max(1, int(batch))
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
            with obs.span("plan", m=m, n=n, k=k, batch=batch) \
                    if obs.enabled() else obs.NULL_SPAN as sp:
                plan = registry.select_plan(
                    m, n, k, dtype=dtype, platform=torch.device(device).type,
                    signs=self.sign is not None, batch=batch,
                    shared_sequence=shared_sequence,
                    live_planes=self.k_live, autotune=autotune)
                sp.set(method=plan.method, source=plan.source)
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
            # the seed tiles, those the backend takes (cuda_wave: k_b)
            takes = spec.candidates(registry.Problem(m=m, n=n, k=k))[0]
            if takes.n_b is not None or n_b is not None:
                planned["n_b"] = 64 if n_b is None else n_b
            if takes.k_b is not None or k_b is not None:
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
        args = (self.method, self.kwargs, seq.reflect, A, seq.cos, seq.sin,
                seq.sign)
        if not obs.enabled() or obs.traced(A):
            return planned_apply(*args)
        with obs.span("apply", method=self.method, m=int(A.shape[0]),
                      n=int(A.shape[1])):
            out, dt = _timed(A.device, planned_apply, *args)
        self._record_dispatch(A, dt)
        return out

    __call__ = apply

    def apply_direct(self, A):
        """Apply via the backend with PyTorch's own autograd (no custom
        backward): gradients reach the waves through the plain backends;
        a kernel's output carries no gradient."""
        self._check_target(A)
        if self.method == _IDENTITY:
            return A
        seq = self.sequence
        args = (self.method, self.kwargs, seq.reflect, A, seq.cos, seq.sin,
                seq.sign)
        if not obs.enabled() or obs.traced(A):
            return planned_run(*args)
        with obs.span("apply", method=self.method, direct=True):
            out, dt = _timed(A.device, planned_run, *args)
        self._record_dispatch(A, dt)
        return out

    def apply_batched(self, A, sequences=None, *, direct: bool = False):
        """Apply to a batch of targets ``A`` of shape ``(b, m, n)``.

        With ``sequences=None`` the plan's own sequence is applied to
        every target.  With ``sequences`` (``b`` sequences of the plan's
        wave shape) each target gets its own: the serving path.  A
        ``batch_via="fused"`` backend (``cuda_batched``) takes the whole
        batch in one launch; otherwise a shared sequence runs the
        flattened ``(b*m, n)`` problem, and per-request sequences are
        mapped with ``torch.func.vmap`` where the backend allows it and
        looped per target where it does not.  Every route equals ``b``
        separate :meth:`apply` calls bit for bit on the rotation family.

        Under a sign-carrying plan, members may be plain or reflector
        sequences (their signs are materialised at stack time); under an
        unsigned plan every member must share the plan's structure.

        ``direct=False`` differentiates w.r.t. ``A`` through the
        transposed-sequence backward (every request's waves transposed
        into a staircase, run by the same backend: the fused kernel
        skips the staircases' dead triangles); ``direct=True`` uses
        PyTorch's own autograd through the backend.
        """
        if A.ndim != 3:
            raise ValueError(
                f"apply_batched expects A of shape (b, m, n); got "
                f"{tuple(A.shape)}; use apply() for a single target")
        seq = self.sequence
        b, m, n = A.shape
        if self.method == _IDENTITY:
            return A
        if n != seq.n:
            raise ValueError(f"plan built for n={seq.n} targets; got "
                             f"A.shape={tuple(A.shape)}")
        if not obs.enabled() or obs.traced(A):
            return self._apply_batched_impl(A, sequences, direct)
        with obs.span("apply_batched", method=self.method, batch=int(b),
                      m=int(m), n=int(n)):
            out, dt = _timed(A.device, self._apply_batched_impl, A,
                             sequences, direct)
        self._record_dispatch(A, dt, shared=sequences is None)
        return out

    def _apply_batched_impl(self, A, sequences, direct: bool):
        seq = self.sequence
        C, S, G = _request_waves(seq, sequences, A.shape[0])
        run = planned_run if direct else planned_apply_batched
        return run(self.method, self.kwargs, seq.reflect, A, C, S, G)

    def _check_target(self, A):
        if self.method == _IDENTITY:
            return
        if A.ndim != 2 or A.shape[1] != self.sequence.n:
            raise ValueError(
                f"plan built for n={self.sequence.n} targets; "
                f"got A.shape={tuple(A.shape)}")

    def _record_dispatch(self, A, measured_s: float,
                         shared: bool = True) -> None:
        """Roofline-attribute one completed dispatch (obs on, concrete
        ``A``): the SS6 model's predicted flops, bytes and seconds for this
        problem, backend and tiles, priced by the platform record of
        ``A``'s device (the H100 on the card), with per-sequence setup
        priced per request when the batch carried its own sequences
        (``shared=False``), beside the measured seconds."""
        _record_roofline(self, _problem_of(self.sequence, A, shared,
                                           A.device.type), measured_s)
        obs.inc("sequence.applies")
        obs.observe("sequence.apply_seconds", measured_s)

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

    # -- serialization -----------------------------------------------------
    def to_dict(self) -> dict:
        """Serialise the dispatch decision (not the waves) to JSON.

        Method, resolved kwargs, the registry :class:`~repro_torch.core.
        registry.Plan` and the wave shape/dtype/sign signature it was
        made for, keyed by the running torch and CUDA versions:
        :meth:`from_dict` rejects a stale or mismatched entry.
        """
        seq = self.sequence
        d = {"format": PLAN_DICT_FORMAT, "torch": registry._version_str(),
             "method": self.method, "kwargs": dict(self.kwargs),
             "shape": list(seq.shape), "dtype": _dtype_name(seq.dtype),
             "signed": seq.sign is not None, "reflect": bool(seq.reflect)}
        if self.plan is not None:
            d["plan"] = {"method": self.plan.method, "n_b": self.plan.n_b,
                         "k_b": self.plan.k_b,
                         "est_seconds": self.plan.est_seconds,
                         "source": self.plan.source}
        return d

    @classmethod
    def from_dict(cls, d: dict, sequence: RotationSequence) -> "SequencePlan":
        """Rebuild a plan from :meth:`to_dict`, bound to ``sequence``.

        Raises ``ValueError`` when the entry is unusable: unknown format,
        another torch/CUDA build, a wave shape, dtype or sign structure
        other than ``sequence``'s, or a backend no longer registered.
        Callers holding stored plans treat the error as a miss and plan
        again.
        """
        _ensure_backends()
        if d.get("format") != PLAN_DICT_FORMAT:
            raise ValueError(
                f"unsupported SequencePlan dict format {d.get('format')!r}")
        now = registry._version_str()
        if d.get("torch") != now:
            raise ValueError(f"plan serialised under {d.get('torch')!r}; "
                             f"running {now!r}: plan again")
        if tuple(d.get("shape", ())) != tuple(sequence.shape):
            raise ValueError(f"plan serialised for wave shape "
                             f"{d.get('shape')}; sequence has "
                             f"{sequence.shape}")
        if d.get("signed", False) != (sequence.sign is not None) \
                or d.get("reflect", False) != bool(sequence.reflect):
            raise ValueError(
                "plan serialised for a different sign/reflect structure")
        if d.get("dtype") != _dtype_name(sequence.dtype):
            raise ValueError(f"plan serialised for dtype "
                             f"{d.get('dtype')!r}; sequence is "
                             f"{sequence.dtype}")
        method = d["method"]
        if method != _IDENTITY:
            spec = registry.get_backend(method)  # raises on unknown
            if sequence.sign is not None \
                    and not spec.capability.supports_signs:
                raise ValueError(
                    f"serialised method {method!r} cannot carry signs")
        kwargs = tuple(sorted(d.get("kwargs", {}).items()))
        plan = None
        pd = d.get("plan")
        if pd is not None:
            plan = registry.Plan(
                method=str(pd.get("method", method)), n_b=pd.get("n_b"),
                k_b=pd.get("k_b"),
                est_seconds=float(pd.get("est_seconds", 0.0)),
                source="persisted")
        return cls(sequence, method, kwargs, plan)


# --------------------------------------------------------------------------
# planned application with a transposed-sequence backward
# --------------------------------------------------------------------------

def _transpose_waves(cos, sin, sign, reflect: bool):
    """Anti-diagonal staircase repack of ``(..., n-1, k)`` wave grids.

    Leading dimensions (a stack of per-request grids) are repacked
    together.  Returns ``(c_t, s_t, g_t, reflect_t)``; ``g_t`` is
    ``None`` for plain rotations and a sign grid otherwise (identity
    padding off the staircase must stay a rotation no-op).
    """
    J, k = cos.shape[-2:]
    lead = cos.shape[:-2]
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
        c_t = one.expand(*lead, J, max(J - 1, 0)).clone()
        s_t = torch.zeros_like(c_t)
        g_src = None
    else:
        c_t = torch.where(valid, cos[..., jb, pc], one)
        s_t = torch.where(valid, s_signed[..., jb, pc], 0 * one)
        g_src = sign[..., jb, pc] if sign is not None else None
    g_t = None
    if sign is not None:
        g_t = (torch.where(valid, g_src, _ROT * one) if g_src is not None
               else torch.full_like(c_t, _ROT))
    elif reflect:
        g_t = torch.where(valid, _REFL * one, _ROT * one).expand_as(c_t)
    return c_t, s_t, g_t, (False if g_t is not None else reflect)


def _problem_of(seq: RotationSequence, A, shared: bool, platform: str,
                **sharding) -> registry.Problem:
    """The registry problem of one dispatch of ``seq`` to ``A`` (a
    ``(m, n)`` target or a ``(b, m, n)`` batch)."""
    b, m = (int(A.shape[0]), int(A.shape[1])) if A.ndim == 3 \
        else (1, int(A.shape[0]))
    return registry.Problem(
        m=m, n=seq.n, k=seq.k, dtype=_dtype_name(A.dtype), platform=platform,
        signs=seq.sign is not None, batch=b, shared_sequence=shared,
        live_planes=seq.k_live, **sharding)


def _record_roofline(plan, problem: registry.Problem, measured_s: float,
                     **extra) -> None:
    """One roofline record of a completed dispatch of ``plan`` (a
    :class:`SequencePlan` or a sharded one): the SS6 model's flops,
    bytes and seconds for ``problem`` at the plan's backend and tiles,
    beside the measured seconds; ``extra`` reaches
    ``obs.roofline.record_dispatch`` (a sharded dispatch's
    ``comm_bytes`` and ``launches_per_shard``)."""
    seq, kw = plan.sequence, dict(plan.kwargs)
    rplan = plan.plan if plan.plan is not None else registry.Plan(
        method=plan.method, n_b=kw.get("n_b"), k_b=kw.get("k_b"))
    comp = registry.cost_components(plan.method, problem, rplan)
    obs.roofline.record_dispatch(
        backend=plan.method, m_total=problem.m_total, n=seq.n, k=seq.k,
        batch=problem.batch, dtype=problem.dtype,
        tile={key: val for key, val in kw.items() if key in ("n_b", "k_b")},
        planes_live=problem.planes_live, planes_total=problem.planes_total,
        predicted_flops=comp["flops"], predicted_bytes=comp["bytes"],
        predicted_s=comp["seconds"], measured_s=measured_s,
        predicted_setup_s=comp["setup"]["seconds"],
        predicted_stream_s=comp["stream"]["seconds"],
        shared_sequence=problem.shared_sequence, **extra)


def _request_waves(seq: RotationSequence, sequences, b: int):
    """The waves of one batched application under ``seq``'s plan: its
    own with ``sequences=None``, else the ``b`` requests' checked and
    stacked."""
    if sequences is None:
        return seq.cos, seq.sin, seq.sign
    seqs = list(sequences)
    if len(seqs) != b:
        raise ValueError(f"{len(seqs)} sequences for a batch of {b} targets")
    plan_signed = seq.sign is not None
    for s in seqs:
        if not isinstance(s, RotationSequence):
            raise TypeError(f"expected RotationSequence, got {type(s)}")
        if tuple(s.shape) != tuple(seq.shape):
            raise ValueError(
                f"sequence shape {s.shape} != plan shape {seq.shape}; "
                f"pad_to a bucket-stable wave count first")
        if not plan_signed and (s.sign is not None
                                or s.reflect != seq.reflect):
            raise ValueError(
                "mixed sign/reflect structure in one batch; plan the "
                "bucket on a sign-carrying representative "
                "(RotationSequence.with_signs()) first")
    return _stack_waves(seqs, plan_signed)


def _stack_waves(seqs, plan_signed: bool):
    """Stack per-request waves into ``(b, n-1, k)`` tensors.

    ``G`` is ``None`` unless the plan carries signs; then every member's
    sign grid is materialised (plain members as ``-1``, reflectors as
    ``+1``), which is where a bucket's implicit signs become explicit.
    """
    C = torch.stack([s.cos for s in seqs])
    S = torch.stack([s.sin for s in seqs])
    G = torch.stack([s._sign_array() for s in seqs]) if plan_signed \
        else None
    return C, S, G


def _timed(device, run, *args):
    """``run(*args)`` and its seconds on the host clock between two
    synchronizes of ``device``: the card's work, not the enqueue."""
    obs.timing.sync(device)
    t0 = obs.timing.now()
    out = run(*args)
    obs.timing.sync(device)
    return out, obs.timing.now() - t0


def _run_backend(method: str, kwargs: Tuple[Tuple[str, Any], ...],
                 reflect: bool, A, C, S, G):
    spec = registry.get_backend(method)
    return spec.fn(A, C, S, reflect=reflect, G=G, **dict(kwargs))


def _run_batched(method: str, kwargs: Tuple[Tuple[str, Any], ...],
                 reflect: bool, A, C, S, G):
    """One batched application: ``A`` ``(b, m, n)``, waves shared
    ``(n-1, k)`` or stacked ``(b, n-1, k)``, routed by capability."""
    spec = registry.get_backend(method)
    cap = spec.capability
    kw = dict(kwargs)
    if cap.batch_via == "fused":
        return spec.fn(A, C, S, reflect=reflect, G=G, **kw)
    b, m, n = A.shape
    if C.ndim == 2:
        if cap.batch_via == "flatten":
            out = spec.fn(A.reshape(b * m, n), C, S, reflect=reflect, G=G,
                          **kw)
            return out.reshape(b, m, n)
        C, S = C.expand(b, *C.shape), S.expand(b, *S.shape)
        G = None if G is None else G.expand(b, *G.shape)
    if cap.supports_vmap:
        if G is None:
            return torch.func.vmap(lambda a, c, s: spec.fn(
                a, c, s, reflect=reflect, **kw))(A, C, S)
        return torch.func.vmap(lambda a, c, s, g: spec.fn(
            a, c, s, reflect=reflect, G=g, **kw))(A, C, S, G)
    return torch.stack([
        spec.fn(A[i], C[i], S[i], reflect=reflect,
                G=None if G is None else G[i], **kw) for i in range(b)])


class _PlannedApply(torch.autograd.Function):
    """``A @ Q`` through a planned backend; backward is ``dY @ Q^T``.

    ``run`` is :func:`_run_backend` for one target or :func:`_run_batched`
    for a batch; the backward transposes every sequence into its
    staircase and runs it through the same backend.
    """

    @staticmethod
    def forward(ctx, A, run, method, kwargs, reflect, C, S, G):
        ctx.run, ctx.method, ctx.kwargs = run, method, kwargs
        ctx.reflect = reflect
        ctx.save_for_backward(C, S, G)
        return run(method, kwargs, reflect, A, C, S, G)

    @staticmethod
    def backward(ctx, dY):
        C, S, G = ctx.saved_tensors
        c_t, s_t, g_t, refl_t = _transpose_waves(C, S, G, ctx.reflect)
        method, kwargs = ctx.method, ctx.kwargs
        if g_t is not None and \
                not registry.get_backend(method).capability.supports_signs:
            # transposing an all-reflector sequence materializes a mixed
            # sign grid; route the cotangent through the blocked family
            method, kwargs = "blocked", tuple(
                (key, val) for key, val in kwargs if key in ("n_b", "k_b"))
        dA = ctx.run(method, kwargs, refl_t, dY.contiguous(), c_t, s_t, g_t)
        return dA, None, None, None, None, None, None, None


# --------------------------------------------------------------------------
# shard-local execution hooks (repro_torch.dist)
# --------------------------------------------------------------------------
#
# repro_torch.dist runs each shard's work through these, never through a
# kernel module: the same planned calls as a SequencePlan, on a shard's
# rows.  Rows differentiate independently, so the transposed-sequence
# backward of a shard needs no collective.

def planned_apply(method, kwargs, reflect, A, C, S, G):
    """Planned application to one ``(m, n)`` target with the
    transposed-sequence backward (:meth:`SequencePlan.apply`)."""
    return _PlannedApply.apply(A, _run_backend, method, kwargs, reflect,
                               C, S, G)


def planned_apply_batched(method, kwargs, reflect, A, C, S, G):
    """Planned application to a ``(b, m, n)`` batch, waves shared
    ``(n-1, k)`` or stacked ``(b, n-1, k)``, routed as
    :meth:`SequencePlan.apply_batched` routes them, with the
    transposed-sequence backward."""
    return _PlannedApply.apply(A, _run_batched, method, kwargs, reflect,
                               C, S, G)


def planned_run(method, kwargs, reflect, A, C, S, G):
    """Planned application with PyTorch's own autograd through the
    backend (:meth:`SequencePlan.apply_direct`); a ``(b, m, n)`` target
    takes the batched route."""
    run = _run_batched if A.ndim == 3 else _run_backend
    return run(method, kwargs, reflect, A, C, S, G)


def stack_request_waves(seqs, plan_signed: bool):
    """Stack ``b`` per-request sequences into ``(b, n-1, k)`` waves
    (signs materialised only under a sign-carrying plan)."""
    return _stack_waves(seqs, plan_signed)
