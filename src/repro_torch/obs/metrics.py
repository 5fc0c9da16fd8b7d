"""Counters, gauges, and deterministic log-spaced-bucket histograms.

Mirror of :mod:`repro.obs.metrics`, copied as it is (pure Python).

Design constraints:

- **No wall-clock or RNG anywhere in here.**  Histograms bucket by pure
  arithmetic on the observed value; callers that want to observe a
  duration measure it themselves via :mod:`repro_torch.obs.timing`.
- **Deterministic buckets.**  Bucket boundaries are fixed log-spaced
  points (``_BASE * 10**(i / _PER_DECADE)``), so the *structure* of a
  snapshot — which metrics exist, observation counts, bucket layout —
  is bit-identical across runs of the same workload.  Only fields
  derived from observed *values* (sum/min/max/percentiles and, for
  seconds-valued histograms, the bucket distribution itself) vary with
  machine speed; :func:`zeroed_timings` strips exactly those so tests
  can assert bit-identical snapshots.
- **Snapshot is plain JSON.**  ``snapshot()`` returns nested dicts of
  str/int/float only, sorted keys, ready for ``json.dump``.

Metric names are dotted, lowercase, ``component.thing`` (e.g.
``registry.plan_cache.hits``, ``serve.request_latency_seconds``).  The
README's "Observability" sections tabulate every name emitted by the
instrumented seams.
"""
from __future__ import annotations

import json
import math
import threading
from typing import Dict, Iterable, Optional

# Histogram bucket i covers [_BASE * 10**(i/_PER_DECADE),
# _BASE * 10**((i+1)/_PER_DECADE)).  _BASE=1e-7 s puts sub-100ns
# observations in bucket 0; 10 buckets per decade gives ~26% relative
# resolution, plenty for p50/p99 on serving latencies.
_BASE = 1e-7
_PER_DECADE = 10
_N_BUCKETS = 110  # covers _BASE .. _BASE * 10**11 = 1e4 s


def bucket_index(value: float) -> int:
    """Deterministic bucket for ``value`` (clamped to the range)."""
    if value <= _BASE:
        return 0
    i = int(math.floor(math.log10(value / _BASE) * _PER_DECADE))
    return min(max(i, 0), _N_BUCKETS - 1)


def bucket_bounds(i: int) -> tuple[float, float]:
    lo = _BASE * 10.0 ** (i / _PER_DECADE)
    hi = _BASE * 10.0 ** ((i + 1) / _PER_DECADE)
    return lo, hi


class Counter:
    """Thread-safe monotonic counter.

    Metrics are mutated concurrently — the stream engine's scheduler
    and dispatcher threads and the caller's thread all increment
    serving counters — so every mutator serializes on a lock
    (registry-shared when created through :class:`MetricsRegistry`, so
    snapshots are consistent cuts).  ``value += delta`` without it is a
    load/add/store race that silently drops increments.
    """

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: Optional[threading.Lock] = None):
        self.name = name
        self.value = 0
        self._lock = lock if lock is not None else threading.Lock()

    def inc(self, delta: int = 1) -> None:
        with self._lock:
            self.value += delta


class Gauge:
    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str, lock: Optional[threading.Lock] = None):
        self.name = name
        self.value = 0.0
        self._lock = lock if lock is not None else threading.Lock()

    def set(self, value: float) -> None:
        v = float(value)  # coerce outside the lock: may raise
        with self._lock:
            self.value = v


class Histogram:
    """Log-spaced-bucket histogram; ``unit="seconds"`` marks fields as
    timing-derived for :func:`zeroed_timings`.  ``observe`` mutates
    five fields together, so concurrent observers serialize on the
    (registry-shared) lock to keep count/sum/buckets mutually
    consistent."""

    __slots__ = ("name", "unit", "count", "sum", "min", "max", "buckets",
                 "_lock")

    def __init__(self, name: str, unit: str = "seconds",
                 lock: Optional[threading.Lock] = None):
        self.name = name
        self.unit = unit
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf
        self.buckets: Dict[int, int] = {}
        self._lock = lock if lock is not None else threading.Lock()

    def observe(self, value: float) -> None:
        v = float(value)
        i = bucket_index(v)
        with self._lock:
            self.count += 1
            self.sum += v
            if v < self.min:
                self.min = v
            if v > self.max:
                self.max = v
            self.buckets[i] = self.buckets.get(i, 0) + 1

    def percentile(self, q: float) -> float:
        """Percentile estimate from the cumulative bucket counts:
        geometric midpoint of the bucket containing quantile ``q``."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        seen = 0
        for i in sorted(self.buckets):
            seen += self.buckets[i]
            if seen >= target:
                lo, hi = bucket_bounds(i)
                return math.sqrt(lo * hi)
        lo, hi = bucket_bounds(max(self.buckets))
        return math.sqrt(lo * hi)


class MetricsRegistry:
    """Process-global named metrics; thread-safe creation *and*
    mutation (every metric shares the registry lock, so a snapshot is
    a consistent cut across all metrics), plain-dict snapshot export."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            with self._lock:
                c = self._counters.setdefault(name,
                                              Counter(name, self._lock))
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            with self._lock:
                g = self._gauges.setdefault(name, Gauge(name, self._lock))
        return g

    def histogram(self, name: str, unit: str = "seconds") -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            with self._lock:
                h = self._histograms.setdefault(
                    name, Histogram(name, unit, self._lock))
        return h

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()

    def snapshot(self) -> dict:
        with self._lock:
            counters = {n: c.value for n, c in sorted(self._counters.items())}
            gauges = {n: g.value for n, g in sorted(self._gauges.items())}
            hists = {}
            for n, h in sorted(self._histograms.items()):
                hists[n] = {
                    "unit": h.unit,
                    "count": h.count,
                    "sum": h.sum,
                    "min": 0.0 if h.count == 0 else h.min,
                    "max": 0.0 if h.count == 0 else h.max,
                    "p50": h.percentile(0.50),
                    "p99": h.percentile(0.99),
                    "buckets": {str(i): h.buckets[i]
                                for i in sorted(h.buckets)},
                }
        return {"counters": counters, "gauges": gauges,
                "histograms": hists}


GLOBAL = MetricsRegistry()


def zeroed_timings(snap: dict) -> dict:
    """Copy of a snapshot with machine-speed-dependent fields zeroed.

    Counters, gauges, histogram observation counts, and the bucket
    distributions of count-valued histograms (``unit != "seconds"``)
    are kept verbatim — they are deterministic for a fixed workload.
    For seconds-valued histograms the value-derived fields
    (sum/min/max/p50/p99/buckets) are zeroed; roofline records (if
    present) lose ``measured_s`` / ``model_fraction``.  Two runs of the
    same request stream must produce bit-identical zeroed snapshots.
    """
    out = json.loads(json.dumps(snap))  # cheap deep copy, JSON-clean
    for h in out.get("histograms", {}).values():
        if h.get("unit") == "seconds":
            h["sum"] = 0.0
            h["min"] = 0.0
            h["max"] = 0.0
            h["p50"] = 0.0
            h["p99"] = 0.0
            h["buckets"] = {}
    roof = out.get("roofline")
    if roof:
        for rec in roof.get("dispatches", []):
            rec["measured_s"] = 0.0
            rec["model_fraction"] = 0.0
        for agg in roof.get("by_backend", {}).values():
            agg["measured_s"] = 0.0
            agg["model_fraction"] = 0.0
    return out


def merge_names(*groups: Iterable[str]) -> list[str]:
    """Sorted union of metric-name iterables (doc/report helper)."""
    names: set[str] = set()
    for g in groups:
        names.update(g)
    return sorted(names)
