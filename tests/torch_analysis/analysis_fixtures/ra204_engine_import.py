# repro-torch-lint: fixture-as=src/repro_torch/serve/stream.py
"""RA204 fixture: the stream engine reaching below the service."""
import threading

from repro_torch.core.sequence import SequencePlan  # expect: RA204


def drain(plan: SequencePlan, lock: threading.Lock):
    with lock:
        return plan
