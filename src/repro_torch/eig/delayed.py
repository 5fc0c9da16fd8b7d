"""Delayed application of recorded rotation waves (paper SS5.1).

Mirror of :mod:`repro.eig.delayed`.  The eigensolvers generate
rotations one scalar at a time on the host but apply them to the
eigen/singular-vector accumulator in bulk: a
:class:`DelayedRotationBuffer` holds the accumulator tensor on its own
device and queues waves until ``k_delay`` are pending, then flushes
them as one :class:`~repro_torch.core.sequence.RotationSequence`
through a cached frozen :class:`~repro_torch.core.sequence.SequencePlan`.
The registry (cost model and plan cache, or measured autotune) is
consulted on the first flush of each ``(k, signs)`` shape only; every
later flush rebinds the plan to the fresh waves and calls the chosen
backend directly (on the card, one of the hand-written
kernels: ``cuda_wave`` or ``cuda_mxu`` for a ``(m, n)`` accumulator,
``cuda_batched`` or a flattened route for ``(b, m, n)``).

A partial final batch is identity-padded (``pad_to``: ``c=1, s=0`` is
an exact no-op) so every flush presents the same ``(n-1, k_delay)``
problem and reuses the same plan.

With :mod:`repro_torch.obs` on, a flush opens a ``flush`` span (and a
``rebind`` span when it reuses a plan), counts ``eig.flushes`` and
observes its wave count in the ``eig.waves_per_flush`` histogram
(``unit="waves"``), as the reference does; ``stats`` keeps its counts
either way.

With ``mesh=`` (a ``DeviceMesh``) a flush plans through
:func:`repro_torch.dist.plan_sharded` and applies with ``direct=True``:
the accumulator's rows shard over ``row_axes`` (distributed eigenvector
accumulation), and a sharded flush leaves it a ``DTensor``.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core.sequence import RotationSequence, _as_tensor

__all__ = ["DelayedRotationBuffer"]


class DelayedRotationBuffer:
    """Accumulate ``M <- M @ G_wave`` lazily, flushing every ``k_delay``.

    Args:
      M: the accumulator, ``(m, n)`` (an identity basis, say) or batched
        ``(b, m, n)`` (``b`` bases sharing every pushed wave, flushed in
        one :meth:`~repro_torch.core.sequence.SequencePlan.apply_batched`;
        exact per slice, since rotations act row-wise).  A tensor stays
        on its device; an array goes to the card.
      k_delay: waves buffered per flush (the SS5.1 delay depth).
      method: dispatch method for the flushes; ``"auto"`` consults the
        registry once per flush shape.
      autotune: measure the candidate plans when a flush shape is first
        resolved (``"auto"`` only); later flushes rebind that plan.
      pad_flush: identity-pad a partial flush to ``k_delay`` waves.
      mesh: a ``torch.distributed`` ``DeviceMesh``: flushes resolve a
        row-sharded :class:`~repro_torch.dist.ShardedSequencePlan`
        through :func:`repro_torch.dist.plan_sharded` instead of a
        replicated ``SequencePlan`` (``"auto"`` arbitrates sharded
        against replicated by the comm-extended cost model).
      row_axes: the mesh dimensions the accumulator's rows shard over
        (with ``mesh``).
      apply_kw: extra plan keywords (explicit ``n_b``/``k_b``, say)
        forwarded to ``RotationSequence.plan``.

    A ``mesh`` that is not a ``DeviceMesh`` raises ``TypeError``, a
    ``row_axes`` it does not name ``ValueError``.
    """

    def __init__(self, M, *, k_delay: int = 32, method: str = "auto",
                 autotune: bool = False, pad_flush: bool = True,
                 mesh=None, row_axes=("data",), **apply_kw):
        if mesh is not None:
            from repro_torch.dist.plan import _mesh_devices
            _mesh_devices(mesh, row_axes)
        self.mesh = mesh
        self.row_axes = tuple(row_axes)
        if k_delay < 1:
            raise ValueError(f"k_delay must be >= 1, got {k_delay}")
        self._M = _as_tensor(M, None)
        if self._M.ndim not in (2, 3):
            raise ValueError(
                f"accumulator must be 2D (m, n) or batched 3D (b, m, n), "
                f"got {tuple(self._M.shape)}")
        self.k_delay = int(k_delay)
        self.method = method
        self.autotune = bool(autotune)
        self.pad_flush = bool(pad_flush)
        self.apply_kw = dict(apply_kw)
        self.planes = self._M.shape[-1] - 1
        self.stats = {"flushes": 0, "waves_pushed": 0,
                      "waves_per_flush": []}
        # pending waves as (planes, w) host blocks, w >= 1
        self._c: list = []
        self._s: list = []
        self._g: list = []  # sign blocks; None = all-rotation
        self._pending = 0
        # frozen SequencePlan per flush signature (k_padded, signs):
        # resolved once, rebound to fresh waves on every later flush
        self._plans: dict = {}

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"DelayedRotationBuffer(shape={tuple(self._M.shape)}, "
                f"pending={self._pending}/{self.k_delay}, "
                f"flushes={self.flushes}, method={self.method!r})")

    @property
    def flushes(self) -> int:
        return self.stats["flushes"]

    @property
    def waves_pushed(self) -> int:
        return self.stats["waves_pushed"]

    @property
    def pending(self) -> int:
        return self._pending

    def push(self, c, s, g=None) -> "DelayedRotationBuffer":
        """Queue one wave (``(n-1,)`` cos/sin, optional sign column)."""
        c = _host_column(c)
        s = _host_column(s)
        if c.shape[0] != self.planes or s.shape[0] != self.planes:
            raise ValueError(
                f"wave has {c.shape[0]} planes; accumulator with "
                f"{self._M.shape[-1]} columns needs {self.planes}")
        self._queue(c[:, None], s[:, None],
                    None if g is None else _host_column(g)[:, None])
        return self

    def _queue(self, c, s, g) -> None:
        """Queue a ``(planes, w)`` block that fits the pending flush."""
        self._c.append(c)
        self._s.append(s)
        self._g.append(g)
        self._pending += c.shape[1]
        self.stats["waves_pushed"] += c.shape[1]
        if self._pending >= self.k_delay:
            self.flush()

    def push_sequence(self, seq, S=None, G=None) -> "DelayedRotationBuffer":
        """Queue every wave of a :class:`RotationSequence` in order.

        The legacy raw-array form ``push_sequence(C, S[, G])`` is still
        accepted but deprecated: wrap the waves in a ``RotationSequence``
        instead.
        """
        if isinstance(seq, RotationSequence):
            C, S_ = _host_waves(seq.cos), _host_waves(seq.sin)
            G_ = None if seq.sign is None else _host_waves(seq.sign)
            if G_ is None and seq.reflect:
                G_ = np.ones(C.shape, np.float64)
        else:
            warnings.warn(
                "push_sequence(C, S) with raw wave arrays is deprecated; "
                "push a RotationSequence instead",
                DeprecationWarning, stacklevel=2)
            C, S_ = _host_waves(seq), _host_waves(S)
            G_ = None if G is None else _host_waves(G)
        if C.shape[0] != self.planes or S_.shape[0] != self.planes:
            raise ValueError(
                f"waves have {C.shape[0]} planes; accumulator with "
                f"{self._M.shape[-1]} columns needs {self.planes}")
        # slices that end where each flush ends: the flushes of pushing
        # the waves one by one
        p = 0
        while p < C.shape[1]:
            q = min(C.shape[1], p + self.k_delay - self._pending)
            self._queue(C[:, p:q], S_[:, p:q],
                        None if G_ is None else G_[:, p:q])
            p = q
        return self

    def _pending_sequence(self) -> RotationSequence:
        """Pending waves as one sequence on the accumulator's device,
        identity-padded to ``(n-1, k_delay)`` when ``pad_flush`` is on.

        The waves are stacked and cast on the host, then moved with one
        host-to-device copy an array.
        """
        k = self._pending
        C = np.concatenate(self._c, 1)
        S = np.concatenate(self._s, 1)
        G = None
        if any(g is not None for g in self._g):
            G = np.concatenate(
                [np.full(c.shape, -1.0, np.float64) if g is None else g
                 for c, g in zip(self._c, self._g)], 1)
        dt, dev = self._M.dtype, self._M.device

        def to_dev(x):
            return None if x is None else torch.from_numpy(x).to(dt).to(dev)

        seq = RotationSequence(to_dev(C), to_dev(S), to_dev(G))
        if self.pad_flush and k < self.k_delay:
            seq = seq.pad_to(self.k_delay)
        return seq

    def flush(self):
        """Apply all pending waves through the cached frozen plan."""
        if not self._pending:
            return self._M
        waves = self._pending
        with obs.span("flush", waves=waves, planes=self.planes) \
                if obs.enabled() else obs.NULL_SPAN:
            seq = self._pending_sequence()
            plan_key = (seq.k, seq.sign is not None)
            plan = self._plans.get(plan_key)
            if plan is None:
                # a batched accumulator applies ONE pending sequence to
                # every basis of the (b, m, n) stack: a shared-sequence
                # batch, so the registry prices per-sequence setup once
                if self.mesh is not None:
                    from repro_torch import dist
                    plan = dist.plan_sharded(
                        seq, like=self._M, mesh=self.mesh,
                        row_axes=self.row_axes, method=self.method,
                        autotune=self.autotune, shared_sequence=True,
                        **self.apply_kw)
                else:
                    plan = seq.plan(like=self._M, method=self.method,
                                    autotune=self.autotune,
                                    shared_sequence=True, **self.apply_kw)
                self._plans[plan_key] = plan
            else:
                with obs.span("rebind") if obs.enabled() else obs.NULL_SPAN:
                    plan = plan.rebind(seq)
            # host-driven accumulation is never differentiated through:
            # the direct paths skip the transposed-sequence backward
            if self._M.ndim == 3:
                self._M = plan.apply_batched(self._M, direct=True)
            elif self.mesh is not None:
                # ShardedSequencePlan spells direct as a keyword
                self._M = plan.apply(self._M, direct=True)
            else:
                self._M = plan.apply_direct(self._M)
            self._c.clear()
            self._s.clear()
            self._g.clear()
            self._pending = 0
            self.stats["flushes"] += 1
            self.stats["waves_per_flush"].append(waves)
        obs.inc("eig.flushes")
        obs.observe("eig.waves_per_flush", waves, unit="waves")
        return self._M

    @property
    def value(self):
        """Flush any pending waves and return the accumulator."""
        return self.flush()


def _host_waves(x) -> np.ndarray:
    """A wave grid as a float64 host array (one device-to-host copy)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", torch.float64).numpy()
    return np.asarray(x, np.float64)


def _host_column(x) -> np.ndarray:
    return _host_waves(x).reshape(-1)
