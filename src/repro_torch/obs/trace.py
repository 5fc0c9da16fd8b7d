"""Host-side tracing spans → Chrome trace-event JSON (Perfetto).

Mirror of :mod:`repro.obs.trace`.

Spans are recorded as complete events (``"ph": "X"``) with
microsecond timestamps relative to the first span in the buffer, one
thread lane per Python thread.  :func:`write_trace` emits the
``{"traceEvents": [...]}`` wrapper with one event per line — the file
loads directly in https://ui.perfetto.dev or ``chrome://tracing``.

Spans wrap *host* code (plan resolution, bucket drains, flushes, apply
calls that end in a synchronize).  A span around a CUDA call that does
not synchronize measures the enqueue, and nothing here is meaningful
inside ``torch.func`` transforms, which is why the instrumented seams
guard with :func:`repro_torch.obs.traced` before opening a span.
"""
from __future__ import annotations

import json
import threading
from typing import Any, Dict, List

from repro_torch.obs import runtime, timing

_lock = threading.Lock()
_events: List[Dict[str, Any]] = []
_origin: float | None = None


class _Span:
    """Context manager recording one complete ("X") trace event."""

    __slots__ = ("name", "args", "_t0")

    def __init__(self, name: str, args: Dict[str, Any]):
        self.name = name
        self.args = args
        self._t0 = 0.0

    def __enter__(self) -> "_Span":
        self._t0 = timing.now()
        return self

    def set(self, **kw: Any) -> None:
        """Attach extra args discovered mid-span (e.g. batch size)."""
        self.args.update(kw)

    def __exit__(self, *exc) -> None:
        t1 = timing.now()
        global _origin
        with _lock:
            if _origin is None:
                _origin = self._t0
            _events.append({
                "name": self.name,
                "ph": "X",
                "ts": round((self._t0 - _origin) * 1e6, 3),
                "dur": round((t1 - self._t0) * 1e6, 3),
                "pid": 1,
                "tid": threading.get_ident() & 0xFFFF,
                "args": self.args,
            })


class _NullSpan:
    """Shared no-op span: the disabled fast path allocates nothing."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def set(self, **kw: Any) -> None:
        pass

    def __exit__(self, *exc) -> None:
        pass


NULL_SPAN = _NullSpan()


def span(name: str, **args: Any):
    """Open a span when tracing is live; shared null object otherwise."""
    if not runtime.trace_enabled():
        return NULL_SPAN
    return _Span(name, args)


def events() -> List[Dict[str, Any]]:
    with _lock:
        return list(_events)


def reset() -> None:
    global _origin
    with _lock:
        _events.clear()
        _origin = None


def write_trace(path: str) -> int:
    """Write buffered spans as Chrome trace JSON; returns event count."""
    evs = events()
    with open(path, "w") as f:
        f.write('{"traceEvents": [\n')
        for i, ev in enumerate(evs):
            sep = ",\n" if i + 1 < len(evs) else "\n"
            f.write(json.dumps(ev, sort_keys=True) + sep)
        f.write("]}\n")
    return len(evs)
