"""Observability on/off switch and trace configuration.

Mirror of :mod:`repro.obs.runtime`, with its own state: turning one
package's switch leaves the other's as it was.

``repro_torch.obs`` is zero-overhead when disabled: every public hook
checks :func:`enabled` first and returns a shared null object.  The
switch is read once from ``REPRO_OBS`` at import (default **off**: tests
and every code path that must stay bit-identical never pay for
instrumentation, and on the card the disabled path adds no synchronize),
and can be flipped programmatically for tests and launchers via
:func:`set_enabled` / :func:`override`.

``REPRO_OBS_TRACE`` optionally names a Chrome trace-event JSONL output
path; when set (and obs is on), host-side spans are buffered and
exported there by :func:`repro_torch.obs.write_trace`.

Nothing in this module touches wall clocks or RNG — it is pure
configuration state, safe to import from cost-model and plan-key code.
"""
from __future__ import annotations

import os
from contextlib import contextmanager

_TRUTHY = ("1", "on", "true", "yes")


def _env_enabled() -> bool:
    return os.environ.get("REPRO_OBS", "").strip().lower() in _TRUTHY


_enabled: bool = _env_enabled()
_trace_path: str | None = os.environ.get("REPRO_OBS_TRACE") or None


def enabled() -> bool:
    """True when instrumentation hooks should record."""
    return _enabled


def set_enabled(flag: bool) -> bool:
    """Set the obs switch; returns the previous value."""
    global _enabled
    prev = _enabled
    _enabled = bool(flag)
    return prev


@contextmanager
def override(flag: bool):
    """Temporarily force obs on/off (tests, launchers)."""
    prev = set_enabled(flag)
    try:
        yield
    finally:
        set_enabled(prev)


def trace_enabled() -> bool:
    """True when spans should be buffered for trace export."""
    return _enabled and _trace_path is not None


def trace_path() -> str | None:
    """Configured trace output path (``REPRO_OBS_TRACE``), if any."""
    return _trace_path


def set_trace_path(path: str | None) -> str | None:
    """Set the trace output path; returns the previous value."""
    global _trace_path
    prev = _trace_path
    _trace_path = path
    return prev
