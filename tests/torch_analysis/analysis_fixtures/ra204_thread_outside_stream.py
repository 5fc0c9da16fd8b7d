# repro-torch-lint: fixture-as=src/repro_torch/serve/bad_worker.py
"""RA204 fixture: concurrency primitives outside the stream engine."""
import threading  # expect: RA204
from queue import Queue  # expect: RA204


def bad_background_drain(svc, key):
    jobs = Queue()  # expect: RA204

    def worker():
        while True:
            batch = jobs.get()
            if batch is None:
                return
            svc.execute_batch(key, *batch)

    t = threading.Thread(target=worker, daemon=True)  # expect: RA204
    t.start()
    return jobs, t
