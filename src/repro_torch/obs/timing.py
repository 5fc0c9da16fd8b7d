"""The port's one clock.

Mirror of :mod:`repro.obs.timing`, with the device-aware helpers the
port needs.  Every host-side timing measurement of ``repro_torch`` (span
durations, roofline measured seconds, serving latencies and deadlines,
autotune's candidate times, launcher throughput prints) goes through
this module; no other module of the package, nor ``chip_smoke.py`` or
the kernel tools, names a stdlib clock or ``timeit`` (rule RA502 of
``repro_torch.analysis``; ``tests/test_torch_obs.py`` checks it too).

A CUDA call returns before the card has run it, so a host clock around
it measures the enqueue.  :func:`sync` waits for the card, and the
instrumented seams call it before and after what they time, only while
obs is on: the disabled path never synchronizes.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

__all__ = ["now", "wall_unix", "sync", "call_seconds"]


def now() -> float:
    """Monotonic seconds for interval measurement (perf_counter)."""
    return time.perf_counter()


def wall_unix() -> float:
    """Unix epoch seconds: artifact timestamps only, never keys."""
    return time.time()


def sync(device) -> None:
    """Wait for the work queued on ``device`` (a ``torch.device`` or its
    name): ``torch.cuda.synchronize`` on a CUDA device, nothing on the
    host, whose operations finish before they return."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def call_seconds(fn: Callable, device) -> float:
    """Seconds of one call of ``fn`` on ``device``.

    On the card the call lies between two CUDA events with a synchronize
    before the first and after the second, so the time holds the call's
    own host work between its launches; on the host, :func:`now` around
    the call.
    """
    device = torch.device(device)
    if device.type != "cuda":
        t0 = now()
        fn()
        return now() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    sync(device)
    start.record()
    fn()
    end.record()
    sync(device)
    return start.elapsed_time(end) / 1e3
