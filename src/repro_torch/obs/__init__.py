"""repro_torch.obs: zero-overhead-when-disabled observability.

Mirror of :mod:`repro.obs`, the port's own copy (it imports ``torch``,
``numpy`` and the standard library only, never the reference):

- **Metrics** (:mod:`~repro_torch.obs.metrics`): counters, gauges and
  deterministic log-spaced-bucket histograms, exported as a plain-JSON
  snapshot.  No clock or RNG in any metrics path.
- **Tracing** (:mod:`~repro_torch.obs.trace`): host-side spans around
  plan / resolve / rebind / apply / flush / admit / drain, exported as
  Chrome trace-event JSON viewable in Perfetto.
- **Roofline attribution** (:mod:`~repro_torch.obs.roofline`):
  per-dispatch predicted-vs-measured records driven by the registry's
  SS6 cost model, priced by the H100 record on the card.

``REPRO_OBS=on`` enables recording (default off), ``REPRO_OBS_TRACE=PATH``
additionally buffers spans for trace export; tests and launchers flip
the switch with :func:`set_enabled` / :func:`override`.  The state is
this package's own: ``repro.obs``'s switch does not turn it on.

With obs on, an instrumented dispatch on the card synchronizes before
and after itself (:func:`~repro_torch.obs.timing.sync`), so measured
seconds are the card's work, not the enqueue; with obs off no seam
synchronizes, reads the clock or allocates.  Hooks stand aside for
tensors wrapped by ``torch.func`` transforms (:func:`traced`), the
port's analogue of the reference's tracer guard.

This package is also the port's one clock (:mod:`~repro_torch.obs.timing`).
"""
from __future__ import annotations

import json
from typing import Any

import torch

from repro_torch.compat import is_functorch_wrapped_tensor
from repro_torch.obs import metrics, roofline, runtime, timing, trace
from repro_torch.obs.metrics import zeroed_timings
from repro_torch.obs.runtime import enabled, override, set_enabled
from repro_torch.obs.trace import NULL_SPAN, span

__all__ = [
    "enabled", "set_enabled", "override", "span", "NULL_SPAN", "traced",
    "inc", "gauge", "observe", "snapshot", "reset", "write_metrics_json",
    "write_trace", "zeroed_timings", "timing", "metrics", "roofline",
    "runtime", "trace",
]

_is_wrapped = is_functorch_wrapped_tensor


def traced(x) -> bool:
    """True for a tensor wrapped by a ``torch.func`` transform (``vmap``,
    ``grad``): it has no concrete storage to time or count, so the
    instrumented seams record nothing for it."""
    return isinstance(x, torch.Tensor) and _is_wrapped(x)


def inc(name: str, delta: int = 1) -> None:
    """Bump a counter (no-op while obs is disabled)."""
    if runtime._enabled:
        metrics.GLOBAL.counter(name).inc(delta)


def gauge(name: str, value: float) -> None:
    """Set a gauge (no-op while obs is disabled)."""
    if runtime._enabled:
        metrics.GLOBAL.gauge(name).set(value)


def observe(name: str, value: float, unit: str = "seconds") -> None:
    """Record a histogram observation (no-op while obs is disabled)."""
    if runtime._enabled:
        metrics.GLOBAL.histogram(name, unit).observe(value)


def snapshot() -> dict:
    """Full metrics + roofline snapshot as a JSON-clean dict."""
    snap = metrics.GLOBAL.snapshot()
    snap["roofline"] = roofline.snapshot()
    return snap


def reset() -> None:
    """Clear all recorded metrics, spans, and roofline records."""
    metrics.GLOBAL.reset()
    roofline.reset()
    trace.reset()


def write_metrics_json(path: str, extra: dict[str, Any] | None = None) -> dict:
    """Dump :func:`snapshot` (plus optional ``extra`` meta) to ``path``."""
    snap = snapshot()
    if extra:
        snap["meta"] = extra
    with open(path, "w") as f:
        json.dump(snap, f, indent=1, sort_keys=True)
        f.write("\n")
    return snap


def write_trace(path: str | None = None) -> int:
    """Export buffered spans as Chrome trace JSON; returns event count.

    Defaults to the ``REPRO_OBS_TRACE`` path; no-ops (returns 0) when
    neither is set.
    """
    target = path or runtime.trace_path()
    if not target:
        return 0
    return trace.write_trace(target)
