"""Batched rotation-application serving: plan once, apply many, at scale.

Mirror of :mod:`repro.serve.rotations`.  Independent ``(sequence,
target)`` requests of one shape share one dispatch decision and one
batched pass over memory:

* **shape-bucketed admission**: ``submit(seq, A)`` drops a request into
  the bucket ``(m, n, dtype, k_pad, signed, wave dtype, device)``.  Wave
  counts are identity-padded (:meth:`~repro_torch.core.sequence.
  RotationSequence.pad_to`, an exact no-op) to the bucket's
  next-power-of-two ``k_pad``, so every drain is one plan-cache-stable
  problem.
* **one plan per bucket**: the first drain resolves the registry once,
  pricing the batched per-request problem (``batch=slots``,
  ``shared_sequence=False``); every later drain calls the frozen
  :class:`~repro_torch.core.sequence.SequencePlan` through
  :meth:`~repro_torch.core.sequence.SequencePlan.apply_batched`.  On
  the card ``auto`` plans ``cuda_batched``: one launch per drain, the
  ``pad_to`` identity waves skipped, not multiplied through, in the
  bucket's dtype (float32, bfloat16 or float16; float64 runs a plain
  backend, as the kernel has no float64 entry).
* **slot padding**: a partial drain is padded to ``slots`` with identity
  requests (zero targets, identity waves); results are row views of the
  batch, one per ticket.
* **warm starts**: resolved bucket plans are written to a JSON store
  beside the plan cache (:func:`serve_plan_store_path`, keyed by the
  torch/CUDA build); a warm service binds them with
  :meth:`~repro_torch.core.sequence.SequencePlan.from_dict` and resolves
  nothing for known buckets.

Bitwise contract (as the reference's): bucketed and per-request results
are equal bit for bit for plain, per-entry-sign and all-reflector
sequences on the rotation family (``unoptimized``, ``wavefront``,
``blocked``, ``cuda_wave``, ``cuda_batched`` and their plain versions),
since every path evaluates one plane form with runtime signs.  The
accumulated family (``accumulated``, ``cuda_mxu``) agrees to dtype
accuracy.  The contract assumes finite targets without ``-0.0``: the
fused kernel leaves NaN/inf/``-0.0`` untouched where a multiplied-
through identity would change them.

With :mod:`repro_torch.obs` on, the service counts
``serve.{requests,batches,slots_executed,pad_slots,plans_resolved,
warm_plans}``, sets the ``serve.queue_depth``, ``serve.bucket_fill_ratio``
and ``serve.pad_slot_fraction`` gauges, observes each request's admit to
finished-result seconds in ``serve.request_latency_seconds`` and opens
``admit``/``drain`` spans, as the reference does; ``stats`` keeps its
counts either way.

With ``mesh=`` (a ``DeviceMesh``) bucket plans resolve through
:func:`repro_torch.dist.plan_sharded`: a drain shards the bucket's rows
over ``row_axes``, one ``cuda_batched`` launch a shard on the card, and
results are row views of the ``DTensor`` batch.  Every rank then runs
the service and submits the same requests in the same order, since each
drain is a collective.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import obs
from repro_torch.core import registry
from repro_torch.core.sequence import (RotationSequence, SequencePlan,
                                       _dtype_name, resolve_device)

__all__ = ["RotationService", "BucketKey", "serve_plan_store_path",
           "synthetic_stream", "DEMO_SHAPES"]

_STORE_FORMAT = 1

# the reference's mixed-shape demo workload ((m, n, k), three buckets)
DEMO_SHAPES = ((16, 32, 8), (32, 32, 8), (16, 64, 12))


def synthetic_stream(n_requests: int, *, shapes=DEMO_SHAPES, seed: int = 0,
                     device="cuda"):
    """Seeded mixed-shape ``(sequence, target)`` request stream.

    Targets and angles come from one numpy generator (float32 targets,
    uniform angles in ``[0, 2pi)``), so a seed gives the same requests
    on every device.
    """
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_requests):
        m, n, k = shapes[i % len(shapes)]
        A = rng.standard_normal((m, n)).astype(np.float32)
        theta = rng.uniform(0.0, 2.0 * np.pi, (n - 1, k))
        seq = RotationSequence(
            torch.from_numpy(np.cos(theta).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(theta).astype(np.float32)).to(device))
        out.append((seq, torch.from_numpy(A).to(device)))
    return out


def serve_plan_store_path() -> Optional[str]:
    """Default on-disk store for serialised bucket plans: beside the
    plan cache, off when ``REPRO_PLAN_CACHE`` turns persistence off."""
    base = registry.plan_cache_path()
    if base is None:
        return None
    return os.path.join(os.path.dirname(base), "serve_plans.json")


def _next_pow2(x: int) -> int:
    return 1 << max(0, (max(1, x) - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class BucketKey:
    """Shape/dtype/device class of one admission bucket.

    Both the target dtype and the wave dtype take part: stacking float32
    and float64 waves in one bucket would promote the batch and break
    the bitwise contract.  The device takes part because a bucket is
    one stacked tensor and its plan is priced for one platform.
    """
    m: int
    n: int
    dtype: str
    k_pad: int
    signed: bool
    wave_dtype: str
    device: str

    def as_list(self) -> list:
        return [self.m, self.n, self.dtype, self.k_pad, self.signed,
                self.wave_dtype, self.device]

    @classmethod
    def from_list(cls, parts) -> "BucketKey":
        m, n, dtype, k_pad, signed, wave_dtype, device = parts
        return cls(int(m), int(n), str(dtype), int(k_pad), bool(signed),
                   str(wave_dtype), str(device))


@dataclasses.dataclass
class _Pending:
    ticket: int
    seq: RotationSequence   # padded to the bucket's k_pad
    A: torch.Tensor
    admit_t: Optional[float] = None   # obs on only


class RotationService:
    """Shape-bucketed, batched rotation-application service.

    Args:
      slots: per-bucket batch capacity.  A bucket drains the moment it
        fills; a partial drain is padded to ``slots`` with identity
        requests so the batch keeps one shape.
      method: dispatch method of bucket plans (``"auto"`` prices the
        batched per-request problem through the registry).
      autotune: measure the candidate plans when a bucket is first
        resolved (``"auto"`` only).
      pad_waves: identity-pad each request's waves to the bucket's
        next-power-of-two ``k_pad``; with ``False`` the raw wave count
        is part of the bucket key.
      min_k_pad: floor of ``k_pad`` (no bucket per tiny ``k``).
      store: path of the serialised-plan store; ``None`` uses
        :func:`serve_plan_store_path`, ``False`` turns persistence off.
      warm_start: load serialised plans from ``store`` at construction.
      mesh: a ``torch.distributed`` ``DeviceMesh``: bucket plans resolve
        through :func:`repro_torch.dist.plan_sharded` (``"auto"``
        arbitrates sharded against replicated by the comm-extended cost
        model).  Sharded bucket plans stay in this process: a mesh has no
        JSON form, so the plan store is bypassed.
      row_axes: the mesh dimensions bucket rows shard over (with
        ``mesh``).
      plan_kw: extra keywords for ``RotationSequence.plan`` when a bucket
        is first resolved (explicit ``n_b``/``k_b``, say).

    A ``mesh`` that is not a ``DeviceMesh`` raises ``TypeError``, a
    ``row_axes`` it does not name ``ValueError``.
    """

    def __init__(self, *, slots: int = 8, method: str = "auto",
                 autotune: bool = False, pad_waves: bool = True,
                 min_k_pad: int = 4, store=None, warm_start: bool = True,
                 mesh=None, row_axes=("data",), **plan_kw):
        if slots < 1:
            raise ValueError(f"slots must be >= 1, got {slots}")
        if mesh is not None:
            from repro_torch.dist.plan import _mesh_devices
            _mesh_devices(mesh, row_axes)
        self.mesh = mesh
        self.row_axes = tuple(row_axes)
        self.slots = int(slots)
        self.method = method
        self.autotune = bool(autotune)
        self.pad_waves = bool(pad_waves)
        self.min_k_pad = int(min_k_pad)
        self.plan_kw = dict(plan_kw)
        if store is False:
            self._store_path = None
        else:
            self._store_path = store if store is not None \
                else serve_plan_store_path()
        self._queues: Dict[BucketKey, List[_Pending]] = {}
        self._plans: Dict[BucketKey, SequencePlan] = {}
        self._warm: Dict[BucketKey, dict] = {}        # serialised, unbound
        self._results: Dict[int, torch.Tensor] = {}
        self._next_ticket = 0
        # "requests" counts real admissions only; "slots_executed" every
        # slot run (real and identity pad), so pad slots never inflate a
        # request rate
        self.stats = {"requests": 0, "batches": 0, "plans_resolved": 0,
                      "warm_plans": 0, "padded_slots": 0, "padded_waves": 0,
                      "slots_executed": 0}
        if warm_start:
            self._load_store()

    def __repr__(self) -> str:
        pending = sum(len(q) for q in self._queues.values())
        return (f"RotationService(slots={self.slots}, "
                f"buckets={len(self._queues)}, pending={pending}, "
                f"plans={len(self._plans)})")

    # -- admission ---------------------------------------------------------
    def _bucket_key(self, seq: RotationSequence, A) -> BucketKey:
        m, n = A.shape
        if seq.n != n:
            raise ValueError(
                f"sequence on {seq.n} columns cannot serve a target with "
                f"{n} columns")
        if A.device != seq.device:
            raise ValueError(f"target on {A.device}, sequence on "
                             f"{seq.device}: a request lies on one device")
        k_pad = max(self.min_k_pad, _next_pow2(seq.k)) if self.pad_waves \
            else seq.k
        signed = seq.sign is not None or bool(seq.reflect)
        return BucketKey(m=int(m), n=int(n), dtype=_dtype_name(A.dtype),
                         k_pad=int(k_pad), signed=signed,
                         wave_dtype=_dtype_name(seq.dtype), device=str(A.device))

    @staticmethod
    def _as_target(seq: RotationSequence, A):
        if not isinstance(A, torch.Tensor):
            A = torch.as_tensor(np.asarray(A), device=seq.device)
        if A.ndim != 2:
            raise ValueError(f"targets must be 2D (m, n); got "
                             f"{tuple(A.shape)}")
        return A

    def _normalize(self, seq: RotationSequence, key: BucketKey):
        """Pad to the bucket's wave count; signs stay implicit (a plain
        sequence padded into a signed bucket gets no sign grid here)."""
        if seq.k < key.k_pad:
            self.stats["padded_waves"] += key.k_pad - seq.k
            seq = seq.pad_to(key.k_pad)
        return seq

    def submit(self, seq: RotationSequence, A) -> int:
        """Admit one request; returns a ticket for :meth:`result`.

        A full bucket drains at once; otherwise the request waits for
        :meth:`drain` or :meth:`result`.
        """
        A = self._as_target(seq, A)
        record = obs.enabled()
        with obs.span("admit") if record else obs.NULL_SPAN:
            key = self._bucket_key(seq, A)
            ticket = self._next_ticket
            self._next_ticket += 1
            self.stats["requests"] += 1
            obs.inc("serve.requests")
            queue = self._queues.setdefault(key, [])
            queue.append(_Pending(ticket, self._normalize(seq, key), A,
                                  obs.timing.now() if record else None))
            if record:
                obs.gauge("serve.queue_depth", self._depth())
        if len(queue) >= self.slots:
            self._drain_bucket(key)
        return ticket

    def _depth(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def apply_many(self, pairs) -> list:
        """Submit ``(seq, A)`` pairs, drain, return the results in
        submission order."""
        tickets = [self.submit(seq, A) for seq, A in pairs]
        self.drain()
        return [self.result(t) for t in tickets]

    # -- execution ---------------------------------------------------------
    def drain(self) -> None:
        """Execute every non-empty bucket (partial batches padded)."""
        for key in list(self._queues):
            if self._queues[key]:
                self._drain_bucket(key)

    def result(self, ticket: int):
        """Return (and forget) one request's rotated target, draining
        its bucket if it is still pending."""
        if ticket not in self._results:
            self.drain()
        if ticket not in self._results:
            raise KeyError(f"unknown or already-collected ticket {ticket}")
        return self._results.pop(ticket)

    def _bucket_plan(self, key: BucketKey, rep_seq: RotationSequence, like):
        """The bucket's frozen plan: the warm store first, else the
        registry, once."""
        plan = self._plans.get(key)
        if plan is not None:
            return plan
        if self.mesh is not None:
            from repro_torch import dist
            plan = dist.plan_sharded(rep_seq, like=like, mesh=self.mesh,
                                     row_axes=self.row_axes,
                                     method=self.method,
                                     autotune=self.autotune,
                                     shared_sequence=False, **self.plan_kw)
            self.stats["plans_resolved"] += 1
            obs.inc("serve.plans_resolved")
            self._plans[key] = plan
            return plan
        warm = self._warm.get(key)
        if warm is not None:
            try:
                plan = SequencePlan.from_dict(warm, rep_seq)
                self.stats["warm_plans"] += 1
                obs.inc("serve.warm_plans")
            except ValueError:
                plan = None  # stale entry: plan through the registry
        if plan is None:
            # one distinct sequence per slot: the registry prices the
            # per-sequence setup slots times
            plan = rep_seq.plan(like=like, method=self.method,
                                autotune=self.autotune, batch=self.slots,
                                shared_sequence=False, **self.plan_kw)
            self.stats["plans_resolved"] += 1
            obs.inc("serve.plans_resolved")
            self._warm[key] = plan.to_dict()
            self._save_store()
        self._plans[key] = plan
        return plan

    def assemble_batch(self, key: BucketKey, seqs: list, targets: list):
        """Stack one bucket batch into its slot-stable shape.

        Pads ``seqs``/``targets`` (already padded to ``k_pad``) to
        ``slots`` with identity requests and picks the planning
        representative (sign-carrying in a signed bucket).  Returns
        ``(seqs, A, rep, pad)`` with ``A`` the ``(slots, m, n)`` stack.
        The synchronous drain and the stream dispatcher both run this
        one path, which is what makes streamed results equal synchronous
        ones bit for bit.
        """
        if not seqs or len(seqs) > self.slots:
            raise ValueError(
                f"batch of {len(seqs)} requests for slots={self.slots}")
        pad = self.slots - len(seqs)
        if pad:
            self.stats["padded_slots"] += pad
            dev = targets[0].device
            ident = RotationSequence.identity(key.n, key.k_pad,
                                              dtype=seqs[0].dtype,
                                              device=dev)
            zero = torch.zeros((key.m, key.n), dtype=targets[0].dtype,
                               device=dev)
            seqs = seqs + [ident] * pad
            targets = targets + [zero] * pad
        A = torch.stack(targets)
        rep = seqs[0].with_signs() if key.signed else seqs[0]
        return seqs, A, rep, pad

    def execute_batch(self, key: BucketKey, seqs: list, targets: list):
        """Plan (once per bucket) and run one assembled batch.

        Returns ``(out, pad)``: the ``(slots, m, n)`` result (row ``i``
        per request; pad rows are garbage) and the pad-slot count.  Does
        not wait for the card: ``out`` is enqueued on the current
        stream, so the stream dispatcher can assemble the next batch
        meanwhile.
        """
        n_live = len(seqs)
        seqs, A, rep, pad = self.assemble_batch(key, seqs, targets)
        plan = self._bucket_plan(key, rep, A)
        out = plan.apply_batched(A, sequences=seqs)
        self.stats["batches"] += 1
        self.stats["slots_executed"] += self.slots
        if obs.enabled():
            obs.inc("serve.batches")
            obs.inc("serve.slots_executed", self.slots)
            obs.inc("serve.pad_slots", pad)
            obs.gauge("serve.bucket_fill_ratio", n_live / self.slots)
            obs.gauge("serve.pad_slot_fraction",
                      self.stats["padded_slots"]
                      / max(1, self.stats["slots_executed"]))
        return out, pad

    def bucket_plan_estimate(self, key: BucketKey) -> Optional[float]:
        """Modeled seconds of one batched drain of ``key``'s bucket;
        ``None`` until the bucket is planned."""
        plan = self._plans.get(key)
        if plan is None or plan.plan is None:
            return None
        est = float(plan.plan.est_seconds)
        return est if est > 0 else None

    def _drain_bucket(self, key: BucketKey) -> None:
        while self._queues.get(key):
            queue = self._queues[key]
            record = obs.enabled()
            with obs.span("drain", m=key.m, n=key.n, k_pad=key.k_pad) \
                    if record else obs.NULL_SPAN as sp:
                batch, self._queues[key] = (queue[:self.slots],
                                            queue[self.slots:])
                out, pad = self.execute_batch(key, [p.seq for p in batch],
                                              [p.A for p in batch])
                for i, p in enumerate(batch):
                    self._results[p.ticket] = out[i]
                if record:
                    sp.set(requests=len(batch), pad_slots=pad)
                    obs.timing.sync(out.device)   # the results are done
                    done_t = obs.timing.now()
                    for p in batch:
                        if p.admit_t is not None:
                            obs.observe("serve.request_latency_seconds",
                                        done_t - p.admit_t)
                    obs.gauge("serve.queue_depth", self._depth())

    # -- serialised plan store ---------------------------------------------
    def _load_store(self) -> int:
        """Merge serialised bucket plans from disk; returns the count.

        A missing or corrupt file, another format or another torch/CUDA
        build is ignored wholesale; each entry is checked again by
        ``SequencePlan.from_dict`` when first bound.
        """
        path = self._store_path
        if path is None:
            return 0
        payload = registry._read_versioned_json(path, _STORE_FORMAT)
        if payload is None:
            return 0
        loaded = 0
        for entry in payload.get("plans", []):
            try:
                key = BucketKey.from_list(entry["bucket"])
                plan_dict = dict(entry["plan"])
            except (KeyError, TypeError, ValueError):
                continue
            self._warm.setdefault(key, plan_dict)
            loaded += 1
        return loaded

    def _save_store(self) -> Optional[str]:
        """Write every known bucket plan through to disk (read, merge,
        replace atomically)."""
        path = self._store_path
        if path is None:
            return None
        merged: Dict[Tuple, dict] = {}
        on_disk = registry._read_versioned_json(path, _STORE_FORMAT)
        if on_disk is not None:
            for entry in on_disk.get("plans", []):
                try:
                    merged[tuple(entry["bucket"])] = entry
                except (KeyError, TypeError):
                    continue
        for key, plan_dict in self._warm.items():
            merged[tuple(key.as_list())] = {"bucket": key.as_list(),
                                            "plan": plan_dict}
        payload = {"format": _STORE_FORMAT,
                   "torch": registry._version_str(),
                   "plans": list(merged.values())}
        return registry._atomic_write_json(path, payload,
                                           prefix=".serve_plans.")
