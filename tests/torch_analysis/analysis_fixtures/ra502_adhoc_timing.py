# repro-torch-lint: fixture-as=chip_smoke.py
"""RA502 fixture: ad-hoc stopwatch code in the chip check.

``repro_torch.obs.timing`` is the one clock; a bare ``import time``
stays legal (``time.sleep`` is not a clock).
"""
import time
import timeit  # expect: RA502
from time import perf_counter  # expect: RA502


def measure(fn) -> float:
    t0 = time.perf_counter()  # expect: RA502
    fn()
    return time.perf_counter() - t0  # expect: RA502


def measure_aliased(fn) -> float:
    t0 = perf_counter()  # expect: RA502
    fn()
    return perf_counter() - t0  # expect: RA502


def best_of_three(fn) -> float:
    return min(timeit.repeat(fn, number=1, repeat=3))  # expect: RA502


def backoff() -> None:
    time.sleep(0.01)
