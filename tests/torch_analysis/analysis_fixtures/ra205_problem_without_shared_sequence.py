# repro-torch-lint: fixture-as=src/repro_torch/serve/bad_pricing.py
"""RA205 fixture: a batched Problem priced without saying who owns the
sequence."""
from repro_torch.core import registry
from repro_torch.core.registry import Problem


def bad_bucket_pricing(m, n, k, b):
    return Problem(m=m, n=n, k=k, dtype="float32",  # expect: RA205
                   platform="cuda", batch=b)


def bad_qualified_pricing(m, n, k):
    return registry.Problem(m=m, n=n, k=k,  # expect: RA205
                            dtype="float32", platform="cuda", batch=64)


def fine_unit_batch(m, n, k):
    return Problem(m=m, n=n, k=k, dtype="float32", platform="cuda", batch=1)


def fine_explicit(m, n, k, b):
    return Problem(m=m, n=n, k=k, dtype="float32", platform="cuda",
                   batch=b, shared_sequence=False)
