# repro-torch-lint: fixture-as=src/repro_torch/serve/bad_raw_apply.py
"""RA201 fixture: the raw wrapper reached through an alias.

A grep for a call of the wrapper's literal name finds nothing here; RA201
resolves the import alias and flags both the import and the call.
"""
from repro_torch.core.api import apply_rotation_sequence as _ars  # expect: RA201


def sneaky_apply(A, C, S):
    return _ars(A, C, S)  # expect: RA201
