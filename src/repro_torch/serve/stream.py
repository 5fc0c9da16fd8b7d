"""Continuous batching of rotation requests: mirror of :mod:`repro.serve.stream`.

:class:`StreamEngine` puts two daemon threads (scheduler and dispatcher)
around a depth-1 handoff queue on top of :class:`~repro_torch.serve.
rotations.RotationService`'s buckets.  ``submit()`` admits a request
without touching the card; a bucket closes when it is full or when its
oldest request has waited ``age_factor`` times the bucket plan's modeled
batch time (clamped to ``[min_age_s, max_age_s]``); closed batches run
through the service's own synchronous batch path, so streamed results
equal synchronous drains bit for bit while the next batch is assembled
during the card's work on this one.  Backpressure (``block``/``fail``/
``shed``), deadlines and weighted round robin over buckets are as in the
reference.

The dispatcher enqueues a batch on its thread's current CUDA stream,
records a ``torch.cuda.Event`` and waits on that event alone before it
fulfils the batch's tickets with row views of the result, so a ticket
always resolves to a finished tensor on the device.  A batch that fails
(in planning, launching or on the card) fails its tickets and never
leaves them hanging.

With :mod:`repro_torch.obs` on, the engine counts
``serve.stream.{submitted,completed,shed,rejected,block_waits,
closes_size,closes_age,closes_drain}``, sets ``serve.stream.pending`` at
close and shed time, opens a ``stream.dispatch`` span a batch and
observes each request's admit to finished-result seconds in
``serve.request_latency_seconds`` from the dispatcher thread, after the
batch's event has completed.  Every clock read goes through
:mod:`repro_torch.obs.timing`.
"""
from __future__ import annotations

import math
import queue
import threading
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import torch

from repro_torch import obs
from repro_torch.serve.rotations import BucketKey, RotationService

__all__ = ["StreamEngine", "StreamTicket", "Backpressure",
           "DeadlineExceeded", "EngineClosed"]

_now = obs.timing.now


class Backpressure(RuntimeError):
    """The global pending budget is full and the policy rejects."""


class DeadlineExceeded(RuntimeError):
    """The request was shed because its deadline passed while queued."""


class EngineClosed(RuntimeError):
    """The engine stopped before this request could be served."""


# serialises the lazy creation of a ticket's Event across racing
# result() waiters; held for pointer reads and stores only
_TICKET_EVENT_LOCK = threading.Lock()


class StreamTicket:
    """Future-like handle of one streamed request.

    ``result()`` blocks until the dispatcher fulfils (or fails) the
    ticket and returns the rotated target, a finished tensor on the
    request's device.
    """

    __slots__ = ("key", "seq", "A", "admit_t", "deadline_t",
                 "_event", "_done", "_value", "_error")

    def __init__(self, key: BucketKey, seq, A, admit_t: float,
                 deadline_t: Optional[float]):
        self.key = key
        self.seq = seq
        self.A = A
        self.admit_t = admit_t
        self.deadline_t = deadline_t
        # created on first wait: most tickets are collected after their
        # batch is done and never need one
        self._event: Optional[threading.Event] = None
        self._done = False
        self._value = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._done

    def result(self, timeout: Optional[float] = None):
        """The rotated target (blocks until fulfilled).

        Raises :class:`DeadlineExceeded` if the request was shed,
        :class:`EngineClosed` if the engine stopped without serving it,
        the batch's own error if its batch failed, and ``TimeoutError``
        if ``timeout`` elapses first.
        """
        if not self._done:
            ev = self._event
            if ev is None:
                with _TICKET_EVENT_LOCK:
                    ev = self._event
                    if ev is None:
                        ev = self._event = threading.Event()
            # a fulfil racing the store above either saw the event (and
            # set it) or finished first, and then _done is visible
            if not self._done and not ev.wait(timeout):
                raise TimeoutError(
                    "streamed result not ready within timeout")
        if self._error is not None:
            raise self._error
        return self._value

    # -- dispatcher/scheduler side ----------------------------------------
    def _fulfill(self, value) -> None:
        self._value = value
        self.seq = self.A = None
        self._done = True
        ev = self._event
        if ev is not None:
            ev.set()

    def _fail(self, error: BaseException) -> None:
        self._error = error
        self.seq = self.A = None
        self._done = True
        ev = self._event
        if ev is not None:
            ev.set()


# one closed batch on its way to the dispatcher
_Batch = Tuple[BucketKey, List[StreamTicket], str]


class StreamEngine:
    """Continuous-batching engine over ``RotationService`` buckets.

    Args:
      service: the bucket/plan substrate to execute through; ``None``
        builds a private ``RotationService(slots=slots, **service_kw)``.
        A service passed in must not be driven synchronously while the
        engine runs: the dispatcher thread owns its plans and stats.
      slots: per-bucket batch capacity (without ``service``).
      max_pending: bound on queued, not yet dispatched requests;
        ``submit()`` applies ``backpressure`` once it is reached.
      backpressure: ``"block"`` (wait for room), ``"fail"`` (raise
        :class:`Backpressure`) or ``"shed"`` (drop queued requests whose
        deadline has passed, else raise).
      age_factor: a bucket is held open ``age_factor`` times its plan's
        modeled batch seconds, clamped to ``[min_age_s, max_age_s]``;
        ``min_age_s`` also holds before the bucket's first plan.
      max_burst: most consecutive closes one bucket gets per visit of
        the round robin.
      start: start the threads now (``False`` lets tests drive the
        admission policies inertly).
      mesh, row_axes: row-sharded bucket execution through
        :mod:`repro_torch.dist` (passed to the private
        ``RotationService``).  Every drain is then a collective: each rank
        must close the same batches in the same order, so with more than
        one rank let only full buckets and :meth:`close` close them (age
        limits past the run).
      service_kw: passed to the private ``RotationService``
        (``method=...``, ``autotune=True``, ``store=False``, say).
    """

    def __init__(self, service: Optional[RotationService] = None, *,
                 slots: int = 8, max_pending: int = 256,
                 backpressure: str = "block", age_factor: float = 8.0,
                 min_age_s: float = 0.002, max_age_s: float = 0.25,
                 max_burst: int = 4, start: bool = True, mesh=None,
                 row_axes=("data",), **service_kw):
        if mesh is not None:
            service_kw.update(mesh=mesh, row_axes=row_axes)
        if backpressure not in ("block", "fail", "shed"):
            raise ValueError(f"unknown backpressure policy {backpressure!r}")
        if max_pending < 1:
            raise ValueError(f"max_pending must be >= 1, got {max_pending}")
        if service is not None and service_kw:
            raise ValueError("pass service_kw only without an explicit "
                             "service")
        self.service = service if service is not None \
            else RotationService(slots=slots, **service_kw)
        self.slots = self.service.slots
        self.max_pending = int(max_pending)
        self.backpressure = backpressure
        self.age_factor = float(age_factor)
        self.min_age_s = float(min_age_s)
        self.max_age_s = float(max_age_s)
        self.max_burst = max(1, int(max_burst))

        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)   # scheduler wakeups
        self._space = threading.Condition(self._lock)  # budget waiters
        self._buckets: Dict[BucketKey, Deque[StreamTicket]] = {}
        self._ring: List[BucketKey] = []   # round-robin visit order
        self._ring_idx = 0
        self._bursts: Dict[BucketKey, int] = {}
        self._pending = 0
        self._closing = False
        self._stopped = threading.Event()
        # depth-1 handoff: at most one closed batch waits while the
        # dispatcher executes the previous one (the double buffer)
        self._handoff: "queue.Queue[Optional[_Batch]]" = queue.Queue(1)
        self.stats = {"submitted": 0, "completed": 0, "shed": 0,
                      "rejected": 0, "closes_size": 0, "closes_age": 0,
                      "closes_drain": 0}
        self._scheduler: Optional[threading.Thread] = None
        self._dispatcher: Optional[threading.Thread] = None
        if start:
            self.start()

    # ------------------------------------------------------------ admission
    def submit(self, seq, A, *, deadline_s: Optional[float] = None
               ) -> StreamTicket:
        """Admit one request; returns a :class:`StreamTicket`.

        ``deadline_s`` is a relative latency budget: under ``"shed"`` a
        request whose deadline passes while it is queued may be dropped
        (its ticket raises :class:`DeadlineExceeded`) to admit new work.
        """
        A = self.service._as_target(seq, A)
        key = self.service._bucket_key(seq, A)
        now = _now()
        ticket = StreamTicket(key, seq, A, now,
                              None if deadline_s is None
                              else now + float(deadline_s))
        with self._lock:
            if self._closing:
                raise EngineClosed("submit() after close()")
            while self._pending >= self.max_pending:
                if self.backpressure == "shed":
                    self._shed_expired_locked()
                    if self._pending < self.max_pending:
                        break
                if self.backpressure in ("fail", "shed"):
                    self.stats["rejected"] += 1
                    obs.inc("serve.stream.rejected")
                    raise Backpressure(
                        f"{self._pending} pending >= budget "
                        f"{self.max_pending} (policy={self.backpressure})")
                obs.inc("serve.stream.block_waits")  # block: wait for room
                self._space.wait()
                if self._closing:
                    raise EngineClosed("engine closed while blocked on "
                                       "the pending budget")
            q = self._buckets.get(key)
            if q is None:
                q = self._buckets[key] = deque()
                self._ring.append(key)
            q.append(ticket)
            self._pending += 1
            self.stats["submitted"] += 1
            obs.inc("serve.stream.submitted")
            # wake the scheduler only on a change it can act on: the
            # bucket reaching its size, or its first request (which arms
            # the age timer)
            if len(q) >= self.slots or len(q) == 1:
                self._wake.notify()
        return ticket

    def _shed_expired_locked(self) -> int:
        """Drop queued requests whose deadline has passed; returns count."""
        now = _now()
        shed = 0
        for q in self._buckets.values():
            kept = [t for t in q
                    if t.deadline_t is None or t.deadline_t > now]
            if len(kept) != len(q):
                for t in q:
                    if t.deadline_t is not None and t.deadline_t <= now:
                        t._fail(DeadlineExceeded(
                            f"deadline passed while queued "
                            f"(budget {t.deadline_t - t.admit_t:.4f}s)"))
                        shed += 1
                q.clear()
                q.extend(kept)
        if shed:
            self._pending -= shed
            self.stats["shed"] += shed
            obs.inc("serve.stream.shed", shed)
            obs.gauge("serve.stream.pending", self._pending)
            self._space.notify_all()
        return shed

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "StreamEngine":
        if self._scheduler is not None:
            return self
        self._scheduler = threading.Thread(
            target=self._scheduler_loop, name="repro-torch-stream-scheduler",
            daemon=True)
        self._dispatcher = threading.Thread(
            target=self._dispatcher_loop,
            name="repro-torch-stream-dispatcher", daemon=True)
        self._scheduler.start()
        self._dispatcher.start()
        return self

    def close(self, drain: bool = True) -> None:
        """Stop the engine.

        ``drain=True`` runs every queued request through the normal
        batch path before the threads exit; ``drain=False`` fails the
        queued tickets with :class:`EngineClosed`.  Idempotent.
        """
        with self._lock:
            if self._closing and self._stopped.is_set():
                return
            self._closing = True
            if not drain:
                for q in self._buckets.values():
                    for t in q:
                        t._fail(EngineClosed("engine closed without drain"))
                        self._pending -= 1
                    q.clear()
            self._wake.notify_all()
            self._space.notify_all()
        if self._scheduler is None:
            # never started: nothing to join, but honour drain
            self._drain_inline()
            self._stopped.set()
            return
        self._scheduler.join()
        self._dispatcher.join()
        self._stopped.set()

    def _drain_inline(self) -> None:
        """close(drain=True) on an engine never started: flush here."""
        while True:
            with self._lock:
                batch = self._close_next_locked(draining=True)
            if batch is None:
                return
            self._normalize(batch)
            self._execute(batch)

    def __enter__(self) -> "StreamEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close(drain=True)

    # ------------------------------------------------------- close policy
    def _age_target(self, key: BucketKey) -> float:
        """Seconds a bucket is held open: its plan's modeled batch time
        scaled, or the floor before the bucket is planned."""
        est = self.service.bucket_plan_estimate(key)
        if est is None:
            return self.min_age_s
        return min(self.max_age_s, max(self.min_age_s,
                                       self.age_factor * est))

    def _ready_locked(self, now: float, draining: bool
                      ) -> Optional[Tuple[BucketKey, str]]:
        """First ready bucket in weighted-round-robin order, with why."""
        n = len(self._ring)
        for off in range(n):
            key = self._ring[(self._ring_idx + off) % n]
            q = self._buckets.get(key)
            if not q:
                continue
            if len(q) >= self.slots:
                return key, "size"
            if now - q[0].admit_t >= self._age_target(key):
                return key, "age"
            if draining:
                return key, "drain"
        return None

    def _next_wake_locked(self, now: float) -> Optional[float]:
        """Seconds until the earliest age close (None: nothing pending)."""
        horizon = None
        for key, q in self._buckets.items():
            if not q:
                continue
            due = q[0].admit_t + self._age_target(key) - now
            if horizon is None or due < horizon:
                horizon = due
        return None if horizon is None else max(horizon, 0.0)

    def _close_next_locked(self, draining: bool = False
                           ) -> Optional[_Batch]:
        """Pop the next batch to dispatch, or None if nothing is ready."""
        if not self._ring:
            return None
        ready = self._ready_locked(_now(), draining)
        if ready is None:
            return None
        key, reason = ready
        q = self._buckets[key]
        tickets = [q.popleft() for _ in range(min(self.slots, len(q)))]
        self._pending -= len(tickets)
        # weighted round robin: a bucket still hot keeps the head of the
        # ring for up to max_burst consecutive closes, then yields
        idx = self._ring.index(key)
        weight = min(self.max_burst, int(math.ceil(len(q) / self.slots)))
        if weight < 1 or self._bursts.get(key, 0) + 1 >= self.max_burst:
            self._ring_idx = (idx + 1) % len(self._ring)
            self._bursts[key] = 0
        else:
            self._ring_idx = idx
            self._bursts[key] = self._bursts.get(key, 0) + 1
        self.stats[f"closes_{reason}"] += 1
        if obs.enabled():
            obs.inc(f"serve.stream.closes_{reason}")
            obs.gauge("serve.stream.pending", self._pending)
        self._space.notify_all()
        return key, tickets, reason

    # ------------------------------------------------------------- threads
    def _normalize(self, batch: _Batch) -> None:
        """Pad each ticket's waves to the bucket (outside the lock, so
        submit stays cheap; only one thread runs it at a time)."""
        key, tickets, _ = batch
        for t in tickets:
            t.seq = self.service._normalize(t.seq, key)

    def _scheduler_loop(self) -> None:
        while True:
            with self._lock:
                while True:
                    now = _now()
                    if self._closing:
                        batch = self._close_next_locked(draining=True)
                        break
                    batch = self._close_next_locked()
                    if batch is not None:
                        break
                    self._wake.wait(self._next_wake_locked(now))
            if batch is None:
                break   # closing, and nothing is left
            self._normalize(batch)
            # depth-1 queue: blocks only while one batch is assembled
            # and another is executing
            self._handoff.put(batch)
        self._handoff.put(None)  # dispatcher shutdown sentinel

    def _dispatcher_loop(self) -> None:
        while True:
            item = self._handoff.get()
            if item is None:
                return
            self._execute(item)

    def _execute(self, item: _Batch) -> None:
        key, tickets, reason = item
        with obs.span("stream.dispatch", m=key.m, n=key.n, k_pad=key.k_pad) \
                if obs.enabled() else obs.NULL_SPAN as sp:
            try:
                out, pad = self.service.execute_batch(
                    key, [t.seq for t in tickets], [t.A for t in tickets])
                if out.is_cuda:
                    # wait for this batch only: admission and the
                    # scheduler's next assembly keep running meanwhile
                    done = torch.cuda.Event()
                    done.record(torch.cuda.current_stream(out.device))
                    done.synchronize()
            except BaseException as e:  # fail the tickets, never hang
                for t in tickets:
                    t._fail(e)
                if not isinstance(e, Exception):
                    raise
                return
            if obs.enabled():
                sp.set(requests=len(tickets), pad_slots=pad, close=reason)
                done_t = _now()
                for t in tickets:
                    obs.observe("serve.request_latency_seconds",
                                done_t - t.admit_t)
            for i, t in enumerate(tickets):
                t._fulfill(out[i])
            self.stats["completed"] += len(tickets)
            obs.inc("serve.stream.completed", len(tickets))
